"""Batched TEA key search on device (JAX).

The reference tries ~40 keys per encrypted frame in a Python loop
(tetraear/core/decoder.py:683-783).  Here the whole keys x frames product
runs as one jitted program: TEA round functions are uint32 array ops
vectorized over a (K keys, B payloads) grid, and plaintext scoring
(printable-byte ratio + structure heuristics) reduces on device, so a
10k-carrier fleet can bruteforce every encrypted frame it sees without
leaving the device.

Semantics are identical to tetraear_tpu.crypto.tea (which is itself
bit-exact vs the reference ciphers).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

_DELTA = np.uint32(0x9E3779B9)
_SUM0 = np.uint32((0x9E3779B9 * 32) & 0xFFFFFFFF)


def _payload_sharding(mesh, axis: str | None):
    """NamedSharding placing the payload (B) axis of the search grid on
    the mesh — the keys x payloads product is embarrassingly parallel
    over payloads (per-payload argmax over keys, no cross-payload term),
    so a fleet's whole encrypted-frame backlog decrypts with zero
    collectives in the rounds."""
    from jax.sharding import NamedSharding, PartitionSpec
    axis = axis or mesh.axis_names[0]
    return NamedSharding(mesh, PartitionSpec(axis))


def _pad_rows(v0, v1, mesh, axis: str | None) -> int:
    """Rows to append so the payload axis divides the mesh size — a
    fleet's backlog is an arbitrary count, and jax.device_put rejects
    non-divisible shardings.  Zero rows are harmless for ECB; callers
    slice the results back to the true B."""
    n_dev = mesh.shape[axis or mesh.axis_names[0]]
    return (-v0.shape[0]) % n_dev


def _keys_to_words_tea1(keys: np.ndarray) -> np.ndarray:
    """(K, 10) key bytes -> (K, 5) big-endian uint16 words (as uint32)."""
    k = np.asarray(keys, np.uint8).reshape(-1, 10)
    words = (k[:, 0::2].astype(np.uint32) << 8) | k[:, 1::2]
    return words


def _keys_to_words_tea2(keys: np.ndarray) -> np.ndarray:
    """(K, 16) key bytes -> (K, 4) big-endian uint32 words."""
    k = np.asarray(keys, np.uint8).reshape(-1, 16)
    w = (k[:, 0::4].astype(np.uint32) << 24) \
        | (k[:, 1::4].astype(np.uint32) << 16) \
        | (k[:, 2::4].astype(np.uint32) << 8) \
        | k[:, 3::4].astype(np.uint32)
    return w


def _payload_to_words(payloads: np.ndarray) -> tuple:
    """(B, L) bytes (L % 8 == 0) -> (v0, v1) each (B, L//8) uint32."""
    p = np.asarray(payloads, np.uint8)
    b, length = p.shape
    if length % 8:
        raise ValueError("payload length must be a multiple of 8")
    w = p.reshape(b, length // 8, 2, 4)
    v = ((w[..., 0].astype(np.uint32) << 24)
         | (w[..., 1].astype(np.uint32) << 16)
         | (w[..., 2].astype(np.uint32) << 8)
         | w[..., 3].astype(np.uint32))
    return v[:, :, 0], v[:, :, 1]


def _words_to_bytes(v0: jnp.ndarray, v1: jnp.ndarray) -> jnp.ndarray:
    """(..., W) uint32 pairs -> (..., W*8) bytes."""
    def split(v):
        return jnp.stack([(v >> 24) & 0xFF, (v >> 16) & 0xFF,
                          (v >> 8) & 0xFF, v & 0xFF], axis=-1)
    b = jnp.concatenate([split(v0), split(v1)], axis=-1)  # (..., W, 8)
    return b.reshape(*b.shape[:-2], -1).astype(jnp.uint8)


def _tea1_rounds(v0, v1, kw):
    """Vectorized TEA1 decrypt rounds; kw is (K, 5) uint32, v (K,B,W)."""
    four, five = jnp.uint32(4), jnp.uint32(5)

    def f(v, s, widx):
        k = kw[:, widx][:, None, None]
        return (((v << four) ^ (v >> five) ^ s) + v) ^ (k + s)

    s = _SUM0
    for _ in range(32):
        i1 = (int(s) >> 11) & 3
        v1 = v1 - f(v0, jnp.uint32(s), i1)
        s = np.uint32((int(s) - int(_DELTA)) & 0xFFFFFFFF)
        i0 = int(s) & 3
        v0 = v0 - f(v1, jnp.uint32(s), i0)
    return v0, v1


def _tea2_rounds(v0, v1, kw):
    """Vectorized TEA2/3/4 decrypt rounds; kw is (K, 4) uint32."""
    four, five = jnp.uint32(4), jnp.uint32(5)
    k0 = kw[:, 0][:, None, None]
    k1 = kw[:, 1][:, None, None]
    k2 = kw[:, 2][:, None, None]
    k3 = kw[:, 3][:, None, None]
    s = _SUM0
    for _ in range(32):
        ss = jnp.uint32(s)
        v1 = v1 - (((v0 << four) + k2) ^ (v0 + ss) ^ ((v0 >> five) + k3))
        s = np.uint32((int(s) - int(_DELTA)) & 0xFFFFFFFF)
        ss = jnp.uint32(s)
        v0 = v0 - (((v1 << four) + k0) ^ (v1 + ss) ^ ((v1 >> five) + k1))
    return v0, v1


def _score_bytes(plain: jnp.ndarray) -> jnp.ndarray:
    """(K, B, L) plaintext bytes -> (K, B) plausibility score.

    Device projection of the reference's scoring heuristics
    (decoder.py:698-733): printable-ASCII density, non-degenerate bytes,
    structured-header bonus.
    """
    printable = ((plain >= 32) & (plain <= 126)).astype(jnp.int32)
    score = 2 * jnp.sum(printable, axis=-1)
    nonzero = jnp.any(plain != 0, axis=-1)
    nonff = jnp.any(plain != 0xFF, axis=-1)
    score = score + jnp.where(nonzero & nonff, 30, -50)
    first = plain[..., 0]
    score = score + jnp.where((first != 0) & (first != 0xFF), 10, 0)
    tetra_first = (first == 0x01) | (first == 0x02) | (first == 0x03) | \
        (first == 0x04) | (first == 0x05) | (first == 0x08) | \
        (first == 0x0A) | (first == 0x0C) | (first == 0x82) | \
        (first == 0x83) | (first == 0x07)
    score = score + jnp.where(tetra_first, 20, 0)
    return score


@partial(jax.jit, static_argnames=("algorithm",))
def _decrypt_impl(v0, v1, key_words, algorithm):
    """(B,W) payload words x (K,) keys -> (K, B, L) plaintext bytes."""
    k = key_words.shape[0]
    v0b = jnp.broadcast_to(v0[None], (k,) + v0.shape)
    v1b = jnp.broadcast_to(v1[None], (k,) + v1.shape)
    if algorithm == "TEA1":
        p0, p1 = _tea1_rounds(v0b, v1b, key_words)
    else:
        p0, p1 = _tea2_rounds(v0b, v1b, key_words)
    return _words_to_bytes(p0, p1)


def tea_decrypt_batch(payloads, keys, algorithm: str = "TEA1",
                      mesh=None, axis: str | None = None) -> np.ndarray:
    """Decrypt every payload with every key on device.

    payloads: (B, L) uint8 (L % 8 == 0); keys: list/array of key bytes.
    mesh: optional jax.sharding.Mesh — shards the payload axis over
    ``axis`` (default: the mesh's first axis) so the search runs SPMD
    across chips; results are bit-identical to the unsharded call.
    Returns (K, B, L) uint8 plaintexts — bit-exact vs
    crypto.tea.TEADecryptor.decrypt (ECB) for each (key, payload) pair.
    """
    payloads = np.atleast_2d(np.asarray(payloads, np.uint8))
    if isinstance(keys, (list, tuple)):
        keys = np.stack([np.frombuffer(bytes(k), np.uint8) for k in keys])
    algorithm = algorithm.upper()
    kw = _keys_to_words_tea1(keys) if algorithm == "TEA1" \
        else _keys_to_words_tea2(keys)
    b = payloads.shape[0]
    v0, v1 = _payload_to_words(payloads)
    v0, v1, kw = (jnp.asarray(v0), jnp.asarray(v1), jnp.asarray(kw))
    if mesh is not None:
        pad = _pad_rows(v0, v1, mesh, axis)
        if pad:
            v0 = jnp.pad(v0, ((0, pad), (0, 0)))
            v1 = jnp.pad(v1, ((0, pad), (0, 0)))
        sh = _payload_sharding(mesh, axis)
        v0, v1 = jax.device_put(v0, sh), jax.device_put(v1, sh)
    out = _decrypt_impl(v0, v1, kw,
                        "TEA1" if algorithm == "TEA1" else "TEA2")
    return np.asarray(out)[:, :b]


def batch_decrypt_frames(decoders, frames: list) -> None:
    """Finish deferred decryption for a block's frames with ONE device
    keys x payloads search per cipher family.

    Each frame's key plan and selection loop are EXACTLY the host
    _decrypt_frame path (frame.decoder._build_key_plan /
    _select_decrypt); only the TEA rounds move to device.  Payloads are
    zero-padded to a common width — harmless for ECB, each frame's
    plaintext is truncated back to its own length.
    """
    pending = []
    for f in frames:
        if not f.pop("decryption_pending", False):
            continue
        dec = decoders[f.get("carrier", 0)]
        plan = dec._build_key_plan(f)
        if plan is None:
            continue
        pending.append((f, dec, plan))
    if not pending:
        return
    if len(pending) == 1:
        # a lone frame is cheaper on host than one device dispatch
        f, dec, (payload, keys_to_try) = pending[0]
        dec._select_decrypt(f, payload, keys_to_try)
        dec._post_decrypt_sds(f)
        return

    # collect unique keys per cipher family (TEA1 10-byte; TEA2/3/4
    # share the classic-TEA structure, crypto.tea semantics)
    fam_keys = {"TEA1": [], "TEA2": []}
    fam_index = {"TEA1": {}, "TEA2": {}}
    max_len = 0
    for _, _, (payload, keys_to_try) in pending:
        max_len = max(max_len, len(payload))
        for key, _desc, alg in keys_to_try:
            if key is None:
                continue
            fam = "TEA1" if alg == "TEA1" else "TEA2"
            want = 10 if fam == "TEA1" else 16
            if len(key) != want:
                continue               # host loop would raise+skip too
            if key not in fam_index[fam]:
                fam_index[fam][key] = len(fam_keys[fam])
                fam_keys[fam].append(key)

    payload_mat = np.zeros((len(pending), max_len), np.uint8)
    for bi, (_, _, (payload, _)) in enumerate(pending):
        payload_mat[bi, :len(payload)] = np.frombuffer(payload, np.uint8)

    plains = {}
    for fam in ("TEA1", "TEA2"):
        if fam_keys[fam]:
            plains[fam] = tea_decrypt_batch(payload_mat, fam_keys[fam],
                                            fam)

    for bi, (f, dec, (payload, keys_to_try)) in enumerate(pending):

        def plaintext_at(i, _bi=bi, _payload=payload,
                         _keys=keys_to_try):
            key, _desc, alg = _keys[i]
            fam = "TEA1" if alg == "TEA1" else "TEA2"
            ki = fam_index[fam].get(key)
            if ki is None:             # invalid combo: host semantics
                from tetraear_tpu.crypto.tea import TEADecryptor
                return TEADecryptor(key, alg).decrypt(_payload)
            return plains[fam][ki, _bi, :len(_payload)].tobytes()

        dec._select_decrypt(f, payload, keys_to_try, plaintext_at)
        dec._post_decrypt_sds(f)


@partial(jax.jit, static_argnames=("algorithm",))
def _search_impl(v0, v1, key_words, algorithm):
    # broadcast to (K, B, W)
    k = key_words.shape[0]
    v0b = jnp.broadcast_to(v0[None], (k,) + v0.shape)
    v1b = jnp.broadcast_to(v1[None], (k,) + v1.shape)
    if algorithm == "TEA1":
        p0, p1 = _tea1_rounds(v0b, v1b, key_words)
    else:
        p0, p1 = _tea2_rounds(v0b, v1b, key_words)
    plain = _words_to_bytes(p0, p1)          # (K, B, L)
    scores = _score_bytes(plain)             # (K, B)
    best_key = jnp.argmax(scores, axis=0)    # (B,)
    best_score = jnp.max(scores, axis=0)
    return scores, best_key, best_score, plain


def tea_key_search(payloads, keys, algorithm: str = "TEA1",
                   mesh=None, axis: str | None = None) -> dict:
    """Try every key against every payload on device.

    Args:
        payloads: (B, L) uint8 ciphertext rows, L % 8 == 0 (pad first).
        keys: list of key byte strings (10 bytes for TEA1, 16 for
            TEA2/3/4), or an (K, key_len) uint8 array.
        algorithm: 'TEA1' or 'TEA2'/'TEA3'/'TEA4' (aliases, crypto.py
            semantics).
        mesh: optional jax.sharding.Mesh — shards the payload axis over
            ``axis`` (default: first mesh axis); the per-payload scoring
            and argmax stay shard-local, so the fleet-scale search adds
            no collectives and returns bit-identical results.

    Returns dict with:
        scores (K, B) int32, best_key_index (B,), best_score (B,),
        plaintexts (B, L) uint8 — each payload decrypted with its best key.
    """
    payloads = np.atleast_2d(np.asarray(payloads, np.uint8))
    if isinstance(keys, (list, tuple)):
        keys = np.stack([np.frombuffer(bytes(k), np.uint8) for k in keys])
    algorithm = algorithm.upper()
    if algorithm == "TEA1":
        kw = _keys_to_words_tea1(keys)
    else:
        kw = _keys_to_words_tea2(keys)
        algorithm = "TEA2"
    b = payloads.shape[0]
    v0, v1 = _payload_to_words(payloads)
    v0, v1, kw = (jnp.asarray(v0), jnp.asarray(v1), jnp.asarray(kw))
    if mesh is not None:
        pad = _pad_rows(v0, v1, mesh, axis)
        if pad:
            v0 = jnp.pad(v0, ((0, pad), (0, 0)))
            v1 = jnp.pad(v1, ((0, pad), (0, 0)))
        sh = _payload_sharding(mesh, axis)
        v0, v1 = jax.device_put(v0, sh), jax.device_put(v1, sh)
    scores, best_key, best_score, plain = _search_impl(v0, v1, kw,
                                                       algorithm)
    scores = np.asarray(scores)[:, :b]
    best_key = np.asarray(best_key)[:b]
    best_score = np.asarray(best_score)[:b]
    plain = np.asarray(plain)[:, :b]
    best_plain = plain[best_key, np.arange(b)]
    return {
        "scores": scores,
        "best_key_index": best_key,
        "best_score": best_score,
        "plaintexts": best_plain,
    }
