"""Slot-managed device speech-decoder bank (fleet voice synthesis).

The host C decoder keeps one stateful handle per carrier
(api.Pipeline.voice_for) and tops out around ~1.1k realtime voice
carriers on a 4-core thread pool.  DeviceSpeechPool keeps a FIXED batch
of jspeech decoder states on the accelerator and synthesizes every
active voice carrier's frames for a block in ONE jitted dispatch:

  * a carrier maps to a persistent device slot (LRU-evicted when more
    carriers than slots have spoken; an evicted carrier restarts from
    the fresh-decoder state, the same resync a reference decoder
    restart produces);
  * per-call shapes are bucketed (frame count and fetch rows to powers
    of two, slot count fixed) so the jit compiles a handful of programs
    total;
  * only the active rows' PCM leaves the device.

Audio is sample-for-sample identical to the host path
(voice/codec.py decode_params) because jspeech is bit-exact vs the C
decoder — asserted end-to-end in tests/unit/test_device_voice.py.

Fleet scaling: the slot axis is embarrassingly parallel (every leaf of
SpeechState is batch-major, decode_block is a per-row integer recurrence
with no cross-row term), so a ``mesh`` argument shards the pool's slots
across devices with a plain NamedSharding — each device owns slots/N
decoder states, jit partitions the whole decode with ZERO collectives in
the decode body (one gather assembles the requested rows' PCM at the
end).  PCM is bit-identical to the single-device pool for any mesh size
(integer arithmetic — partitioning cannot change a single Word16 op);
asserted at mesh 1/2/4/8 in __graft_entry__.dryrun_multichip.  This is
the "more devices" axis for voice (reference scope: one host codec
call per frame, tetraear/audio/voice.py:73-250).
"""

from __future__ import annotations

import logging
from collections import OrderedDict

import numpy as np

from tetraear_tpu.voice import jspeech

logger = logging.getLogger(__name__)


def _pow2_at_least(n: int, lo: int = 1) -> int:
    v = lo
    while v < n:
        v *= 2
    return v


class DeviceSpeechPool:
    """``synthesize`` maps [(carrier, (n, 138) int16 params)] ->
    [float32 PCM (n*240,)], carrying per-carrier decoder state on
    device between calls."""

    def __init__(self, slots: int = 256, mesh=None, axis: str | None = None):
        """mesh: optional jax.sharding.Mesh; the pool's slot axis is
        sharded over ``axis`` (default: the mesh's first axis name) and
        every decode dispatch runs SPMD across those devices.  slots
        must divide evenly."""
        import jax
        import jax.numpy as jnp

        self.slots = int(slots)
        self.state = jspeech.init_state(self.slots)
        self._map: OrderedDict[int, int] = OrderedDict()   # carrier->slot
        self._free = list(range(self.slots - 1, -1, -1))
        self._row_shard = None
        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec
            axis = axis or mesh.axis_names[0]
            n_dev = mesh.shape[axis]
            if self.slots % n_dev:
                raise ValueError(
                    f"slots={self.slots} not divisible by mesh axis "
                    f"'{axis}' size {n_dev}")
            # every SpeechState leaf is batch-major, so P(axis) shards
            # exactly the slot dimension on each of them
            self._row_shard = NamedSharding(mesh, PartitionSpec(axis))
            self._repl = NamedSharding(mesh, PartitionSpec())
            self.state = jax.device_put(self.state, self._row_shard)

        def step(state, reset_mask, frames, valid, rows):
            state = jspeech.reset_rows(state, reset_mask)
            state, pcm = jspeech.decode_block(state, frames, valid)
            return state, jnp.take(pcm, rows, axis=0)

        self._step = jax.jit(step)

    # -- checkpoint/resume ---------------------------------------------

    def checkpoint_state(self) -> tuple:
        """-> (np leaf list, json-able meta) capturing every device
        decoder state plus the carrier->slot map and LRU order."""
        import jax
        leaves = [np.asarray(l) for l in
                  jax.tree_util.tree_flatten(self.state)[0]]
        meta = {"map": [[int(c), int(s)] for c, s in self._map.items()],
                "free": [int(s) for s in self._free],
                "slots": self.slots}
        return leaves, meta

    def restore_state(self, leaves, meta: dict) -> None:
        import jax
        import jax.numpy as jnp
        if int(meta.get("slots", self.slots)) != self.slots:
            raise ValueError(
                f"checkpoint has {meta.get('slots')} voice slots, pool "
                f"configured with {self.slots}")
        flat, treedef = jax.tree_util.tree_flatten(self.state)
        if len(flat) != len(leaves):
            raise ValueError("voice pool state leaf count mismatch")
        self.state = jax.tree_util.tree_unflatten(
            treedef, [jnp.asarray(l) for l in leaves])
        self._map = OrderedDict((int(c), int(s)) for c, s in meta["map"])
        self._free = [int(s) for s in meta["free"]]

    # -- slot management ---------------------------------------------------

    def _slot_for(self, carrier: int, reset: list) -> int:
        slot = self._map.get(carrier)
        if slot is not None:
            self._map.move_to_end(carrier)
            return slot
        if self._free:
            slot = self._free.pop()
        else:
            old_c, slot = self._map.popitem(last=False)    # LRU evict
            logger.debug("voice slot evict: carrier %s -> %s", old_c,
                         carrier)
            reset.append(slot)
        self._map[carrier] = slot
        self._map.move_to_end(carrier)
        return slot

    # -- synthesis -----------------------------------------------------------

    def synthesize(self, items: list) -> list:
        """items: [(carrier, (n_frames, 138) int16 [BFI + 137 bits])],
        one entry per carrier, frames in stream order.  Returns one
        float32 PCM array per item (Post_Process'd, /32768 scale, same
        as codec.VoiceProcessor.decode_params — near-silence rejection
        is the CALLER's per-slot policy, not applied here)."""
        out: list = [None] * len(items)
        for lo in range(0, len(items), self.slots):
            chunk = items[lo:lo + self.slots]
            for i, pcm in enumerate(self._run(chunk)):
                out[lo + i] = pcm
        return out

    def _run(self, items: list) -> list:
        if not items:
            return []
        reset: list = []
        rows = [self._slot_for(c, reset) for c, _ in items]
        f_max = _pow2_at_least(max(p.shape[0] for _, p in items))
        a_pad = _pow2_at_least(len(items))

        frames = np.zeros((self.slots, f_max, 138), np.int32)
        valid = np.zeros((self.slots, f_max), bool)
        for slot, (_, p) in zip(rows, items):
            frames[slot, :p.shape[0]] = p
            valid[slot, :p.shape[0]] = True
        reset_mask = np.zeros(self.slots, bool)
        reset_mask[reset] = True
        rows_pad = np.zeros(a_pad, np.int32)
        rows_pad[:len(rows)] = rows

        if self._row_shard is not None:
            import jax
            frames = jax.device_put(frames, self._row_shard)
            valid = jax.device_put(valid, self._row_shard)
            reset_mask = jax.device_put(reset_mask, self._row_shard)
            rows_pad = jax.device_put(rows_pad, self._repl)
        self.state, pcm = self._step(self.state, reset_mask, frames,
                                     valid, rows_pad)
        pcm = np.asarray(pcm)                       # (a_pad, f_max, 240)
        return [
            pcm[i, :p.shape[0]].reshape(-1).astype(np.float32) / 32768.0
            for i, (_, p) in enumerate(items)]
