"""Batched ETSI ACELP speech decoder on device (JAX).

The native decoder (voice/csrc/etsi_acelp_dec.cpp, bit-exact vs the
reference sdecoder binary) synthesizes one carrier at a time on the
host (with a thread pool, api.PipelineConfig.voice_threads), so at
fleet scale speech synthesis is a host bottleneck.  This module
decodes a whole fleet's voice frames in ONE jitted program: every
Word16/Word32 operation is the exact saturating basicop
(voice/jfixed.py), recursions (long-term predictor, synthesis filters,
pitch sharpening) run as ``lax.scan`` over samples with the batch in
lanes, and codebook/table lookups are row gathers.

BIT-EXACT vs the C++ decoder for any [BFI + 137 serial bits] frame
stream, including concealment state — pinned by
tests/codec/test_jspeech.py; the C++ decoder is itself pinned to the
ETSI reference binary (tests/codec/test_acelp_oracle.py).

Layout notes (mirrors etsi_acelp_dec.cpp exactly — deviations there
from the published reference, e.g. the one-word excitation-history
over-allocation for the t0=143/frac=+1 corner, are reproduced here;
see that file's comments for the reference citations):
  * state is a pytree of int32 arrays, batch-major;
  * the excitation buffer keeps the C layout: 159 history words +
    240 frame + 60 scratch, shifted by EXC_OFF words per frame;
  * parameter validity is guaranteed by construction (any 137-bit
    pattern maps to in-range codebook indices), so gathers never need
    clamping for correctness — indices are masked only where a BFI
    branch discards the result anyway.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from tetraear_tpu.voice import acelp_tables as T
from tetraear_tpu.voice import jfixed as F

L_FRAME = 240
L_SUBFR = 60
EXC_OFF = 143 + 16            # etsi_acelp_dec.cpp EXC_OFF
EXC_LEN = EXC_OFF + L_FRAME + L_SUBFR


# ---- constant LPC expansion factors (Fac_Pond, exact host ints) --------

def _fac_pond(gamma: int) -> np.ndarray:
    fac = [gamma]
    for _ in range(9):
        p = fac[-1] * gamma * 2               # L_mult (no sat possible)
        fac.append((p + 0x8000) >> 16)        # round_w
    return np.array(fac, np.int32)


F_GAMMA3 = _fac_pond(0x6000)
F_GAMMA4 = _fac_pond(0x6CCD)


class SpeechState(NamedTuple):
    """Per-carrier decoder state, batch-major int32 (Word16 values)."""
    old_exc: jnp.ndarray        # (B, EXC_LEN)
    lspold: jnp.ndarray         # (B, 10)
    lspnew: jnp.ndarray         # (B, 10) — scratch that persists (C)
    mem_syn: jnp.ndarray        # (B, 10)
    old_parm: jnp.ndarray       # (B, 23)
    old_t0: jnp.ndarray         # (B,)
    last_ener_pit: jnp.ndarray  # (B,)
    last_ener_cod: jnp.ndarray  # (B,)


def init_state(batch: int) -> SpeechState:
    z = jnp.zeros
    return SpeechState(
        old_exc=z((batch, EXC_LEN), jnp.int32),
        lspold=jnp.tile(jnp.asarray(T.LSPOLD_INIT)[None], (batch, 1)),
        lspnew=z((batch, 10), jnp.int32),
        mem_syn=z((batch, 10), jnp.int32),
        old_parm=z((batch, 23), jnp.int32),
        old_t0=jnp.full((batch,), 60, jnp.int32),
        last_ener_pit=z((batch,), jnp.int32),
        last_ener_cod=z((batch,), jnp.int32),
    )


def reset_rows(state: SpeechState, mask) -> SpeechState:
    """Reset the masked rows to the fresh-decoder state (slot reuse in
    jspeech_pool.DeviceSpeechPool).  mask: (B,) bool."""
    init = init_state(mask.shape[0])
    return jax.tree_util.tree_map(
        lambda i, s: jnp.where(
            mask.reshape(mask.shape + (1,) * (s.ndim - 1)), i, s),
        init, state)


# ---- transcendentals ----------------------------------------------------

def _log2(L_x):
    """Log2_: (B,) Word32 -> (exponent, fraction) (B,) Word16."""
    e = F.norm_l(L_x)
    Lx = F.L_shl(L_x, e)
    exponent = F.sub(30, e)
    Lx = F.L_shr(Lx, 9)
    i = F.extract_h(Lx)
    Lx = F.L_shr(Lx, 1)
    a = F.extract_l(Lx) & 0x7FFF
    i = F.sub(i, 32)
    ii = jnp.clip(i, 0, 31)                    # in range unless L_x <= 0
    tab = jnp.asarray(T.TAB_LOG2)
    ti = jnp.take(tab, ii)
    ti1 = jnp.take(tab, ii + 1)
    L_y = F.L_deposit_h(ti)
    L_y = F.L_msu(L_y, F.sub(ti, ti1), a)
    frac = F.extract_h(L_y)
    bad = L_x <= 0
    zero = jnp.zeros_like(frac)
    return jnp.where(bad, zero, exponent), jnp.where(bad, zero, frac)


def _pow2(exponent, fraction):
    """Pow2_: (B,) Word16 pair -> (B,) Word32."""
    Lx = F.L_shl(F.L_deposit_l(fraction), 6)
    i = F.extract_h(Lx)
    Lx = F.L_shr(Lx, 1)
    a = F.extract_l(Lx) & 0x7FFF
    ii = jnp.clip(i, 0, 31)
    tab = jnp.asarray(T.TAB_POW2)
    ti = jnp.take(tab, ii)
    ti1 = jnp.take(tab, ii + 1)
    L = F.L_deposit_h(ti)
    L = F.L_msu(L, F.sub(ti, ti1), a)
    return F.L_shr_r(L, F.sub(30, exponent))


# ---- LSP ---------------------------------------------------------------

def _d_lsp334(idx, old_lsp):
    """D_Lsp334: idx (B, 3) codebook indices -> lsp (B, 10)."""
    l1 = jnp.take(jnp.asarray(T.DICO1_CLSP), idx[:, 0], axis=0)
    l2 = jnp.take(jnp.asarray(T.DICO2_CLSP), idx[:, 1], axis=0)
    l3 = jnp.take(jnp.asarray(T.DICO3_CLSP), idx[:, 2], axis=0)
    lsp = jnp.concatenate([l1, l2, l3], axis=1)          # (B, 10)

    tmp = F.add(F.sub(917, lsp[:, 2]), lsp[:, 3])
    hit = tmp > 0
    t2 = F.shr(tmp, 1)
    lsp = lsp.at[:, 2].set(jnp.where(hit, F.add(lsp[:, 2], t2),
                                     lsp[:, 2]))
    lsp = lsp.at[:, 3].set(jnp.where(hit, F.sub(lsp[:, 3], t2),
                                     lsp[:, 3]))
    tmp = F.add(F.sub(1245, lsp[:, 5]), lsp[:, 6])
    hit = tmp > 0
    t2 = F.shr(tmp, 1)
    lsp = lsp.at[:, 5].set(jnp.where(hit, F.add(lsp[:, 5], t2),
                                     lsp[:, 5]))
    lsp = lsp.at[:, 6].set(jnp.where(hit, F.sub(lsp[:, 6], t2),
                                     lsp[:, 6]))

    bad = jnp.zeros(lsp.shape[:1], bool)
    for i in range(9):
        bad |= F.sub(lsp[:, i], lsp[:, i + 1]) <= 0
    return jnp.where(bad[:, None], old_lsp, lsp)


def _get_lsp_pol(lsp5):
    """Get_Lsp_Pol on one cosine-LSP half: list of 5 (B,) Word16 ->
    list of 6 (B,) Word32.  Replays the reference's in-place pointer
    walk exactly (the inner loop revisits lower coefficients)."""
    b = lsp5[0].shape
    f = [None] * 6
    f[0] = jnp.broadcast_to(F.Load_sh(jnp.full(b, 4096, jnp.int32), 12),
                            b)
    f[1] = F.sub_sh(jnp.zeros(b, jnp.int32), lsp5[0], 10)
    p = 2
    li = 1
    for i in range(2, 6):
        f[p] = f[p - 2]
        for _j in range(1, i):
            hi, lo = F.L_extract(f[p - 1])
            t0 = F.L_shl(F.mpy_mix(hi, lo, lsp5[li]), 1)
            f[p] = F.L_add(f[p], f[p - 2])
            f[p] = F.L_sub(f[p], t0)
            p -= 1
        f[p] = F.sub_sh(f[p], lsp5[li], 10)
        p += i
        li += 1
    return f


def _lsp_az(lsp):
    """Lsp_Az: (B, 10) cosine LSPs -> (B, 11) LPC coefficients."""
    f1 = _get_lsp_pol([lsp[:, k] for k in (0, 2, 4, 6, 8)])
    f2 = _get_lsp_pol([lsp[:, k] for k in (1, 3, 5, 7, 9)])
    for i in range(5, 0, -1):
        f1[i] = F.L_add(f1[i], f1[i - 1])
        f2[i] = F.L_sub(f2[i], f2[i - 1])
    cols = [jnp.full(lsp.shape[:1], 4096, jnp.int32)] + [None] * 10
    for i in range(1, 6):
        cols[i] = F.extract_l(F.L_shr_r(F.L_add(f1[i], f2[i]), 13))
        cols[11 - i] = F.extract_l(F.L_shr_r(F.L_sub(f1[i], f2[i]), 13))
    return jnp.stack(cols, axis=1)


def _int_lpc4(lsp_old, lsp_new):
    """Int_Lpc4: (B, 10) x2 -> (B, 44) = 4 interpolated LPC sets."""
    sets = []
    fac_new, fac_old = 0x2000, 0x6000
    for _ in range(3):
        L = F.L_mac(F.L_mult(lsp_old, fac_old), lsp_new, fac_new)
        sets.append(_lsp_az(F.extract_h(L)))
        fac_old -= 0x2000
        fac_new += 0x2000
    sets.append(_lsp_az(lsp_new))
    return jnp.concatenate(sets, axis=1)


def _pond_ai(a, fac: np.ndarray):
    """Pond_Ai with a constant factor table: (B, 11) -> (B, 11)."""
    cols = [a[:, 0]]
    for i in range(1, 11):
        cols.append(F.round_w(F.L_mult(a[:, i], int(fac[i - 1]))))
    return jnp.stack(cols, axis=1)


# ---- filters ------------------------------------------------------------

def _syn_filt_step(a, m, xi):
    """One Syn_Filt sample: a (B, 11), memory m (B, 10) with m[:, 9]
    the most recent output, input xi (B,) -> (new m, y)."""
    L = F.Load_sh(xi, 12)
    for j in range(1, 11):
        L = F.L_msu0(L, a[:, j], m[:, 10 - j])
    L = F.add_sh(L, 1, 11)
    L = F.L_shl(L, 4)
    y = F.extract_h(L)
    return jnp.concatenate([m[:, 1:], y[:, None]], axis=1), y


def _syn_filt(a, x, mem):
    """Syn_Filt over (B, lg) inputs; returns ((B, lg) y, new mem)."""
    def step(m, xi):
        m, y = _syn_filt_step(a, m, xi)
        return m, y
    mem, ys = jax.lax.scan(step, mem, x.T, unroll=10)
    return ys.T, mem


def _lpc_gain(a):
    """Lpc_Gain: (B, 11) -> (B,) Word32 impulse-response energy."""
    b = a.shape[:1]
    x0 = jnp.full(b, 0x400, jnp.int32)

    def step(carry, xi):
        m, L = carry
        m, y = _syn_filt_step(a, m, xi)
        return (m, F.L_mac0(L, y, y)), None

    xs = jnp.concatenate(
        [x0[None], jnp.zeros((L_SUBFR - 1,) + b, jnp.int32)], axis=0)
    (m, L), _ = jax.lax.scan(
        step, (jnp.zeros(b + (10,), jnp.int32), jnp.zeros(b, jnp.int32)),
        xs, unroll=10)
    return L


def _mac0_chain(init, x, y):
    """Sequential saturating sum(x*y) over the last axis (order
    matters: each partial saturates independently)."""
    def step(L, xy):
        xi, yi = xy
        return F.L_mac0(L, xi, yi), None
    L, _ = jax.lax.scan(step, init, (x.T, y.T), unroll=10)
    return L


# ---- adaptive codebook --------------------------------------------------

def _pred_lt(buf, t0, frac, base: int):
    """Pred_Lt on the excitation buffer (B, EXC_LEN) at static offset
    ``base``; t0/frac per carrier.  Each new sample may feed later taps
    (pos - t0 + 16 can reach written samples), so this is a true
    recursion — but a per-sample (B, 33) take_along_axis gather
    inside the scan makes every step wait on a gather.  Here the
    window region is gathered ONCE per subframe
    into a sliding ``ext`` buffer; inside the 60-step scan the window
    read is a batch-uniform dynamic_slice (the scan counter is the
    only offset) and the recursion feedback is a one-hot masked add at
    per-carrier lag t0 + 16 (> 32 always, PIT_MIN = 18, so feedback
    never lands inside the current window read).  Bit-exact: the
    saturating L_mac0 chain is unchanged, only data movement differs.
    """
    coef1 = [int(v) for v in T.COEF1]
    coef2 = [int(v) for v in T.COEF2]
    zero = jnp.zeros_like(t0)
    w_ext = L_SUBFR + 32                       # window span of all steps
    start0 = base - t0 - 16                    # (B,) >= 0 by layout
    j = jnp.arange(w_ext, dtype=jnp.int32)
    ext0 = jnp.take_along_axis(buf, start0[:, None] + j[None], axis=1)
    # positions j >= t0 + 16 alias buf[base + ...] (this subframe's
    # output region): zero them so the one-hot ADD of computed samples
    # is an overwrite
    wrap = (t0 + 16)[:, None]
    ext0 = jnp.where(j[None] < wrap, ext0, 0)

    def step(carry, i):
        ext = carry
        w = jax.lax.dynamic_slice(
            ext, (jnp.int32(0), i), (ext.shape[0], 33))
        v0 = w[:, 16]
        L1 = zero
        L2 = zero
        for k in range(32):
            L1 = F.L_mac0(L1, w[:, k], coef1[k])
            L2 = F.L_mac0(L2, w[:, k + 1], coef2[k])
        v1 = F.round_w(F.L_add(L1, L1))
        v2 = F.round_w(F.L_add(L2, L2))
        val = jnp.where(frac == 0, v0, jnp.where(frac == 1, v1, v2))
        # recursion feedback: sample i is read again (as a tap) at ext
        # position i + t0 + 16; beyond w_ext the one-hot is empty and
        # the write drops (never read again)
        ext = ext + val[:, None] * (j[None] == (i + wrap))
        return ext, val

    _, vals = jax.lax.scan(step, ext0,
                           jnp.arange(L_SUBFR, dtype=jnp.int32),
                           unroll=6)
    return jax.lax.dynamic_update_slice(
        buf, vals.T, (jnp.int32(0), jnp.int32(base)))


def _sharpen(h, t0):
    """Pitch-sharpen the impulse response in place: h (B, 60),
    h[i] += mult(h[i - t0], 0x6668) for i >= t0 (recursive when
    2*t0 <= 59)."""
    ar = jnp.arange(L_SUBFR, dtype=jnp.int32)

    def step(h, i):
        # one-hot masked reduce instead of a per-step gather (same
        # reasoning as _pred_lt); i < t0 -> empty one-hot
        # -> hv = 0, discarded by the i >= t0 select anyway
        sel = ar[None, :] == (i - t0)[:, None]
        hv = jnp.sum(jnp.where(sel, h, 0), axis=1)
        cur = jax.lax.dynamic_slice_in_dim(h, i, 1, axis=1)[:, 0]
        nv = jnp.where(i >= t0, F.add(cur, F.mult(hv, 0x6668)), cur)
        return jax.lax.dynamic_update_slice(
            h, nv[:, None], (jnp.int32(0), i)), None

    h, _ = jax.lax.scan(step, h, jnp.arange(L_SUBFR, dtype=jnp.int32), unroll=6)
    return h


def _d_d4i60(index, sign, shift, h):
    """D_D4i60: algebraic-codebook reconstruction, fully vectorized.
    h (B, 60) weighted impulse response -> cod (B, 60)."""
    p0 = (index & 0x1F) * 2
    p1 = ((index & 0xE0) >> 2) + 2
    p2 = ((index & 0x700) >> 5) + 4
    p3 = ((index & 0x3800) >> 8) + 6
    fbuf = jnp.concatenate(
        [jnp.zeros(h.shape[:1] + (64,), jnp.int32), h], axis=1)
    ar = jnp.arange(L_SUBFR)

    def tap(p):
        idx = (64 - shift - p)[:, None] + ar
        return jnp.take_along_axis(fbuf, idx, axis=1)

    f0, f1, f2, f3 = tap(p0), tap(p1), tap(p2), tap(p3)
    L = F.L_mult0(f0, 0x0B50)
    L = F.sub_sh(L, f1, 11)
    L = F.add_sh(L, f2, 11)
    L = F.sub_sh(L, f3, 11)
    L = jnp.where((sign != 0)[:, None], F.L_negate(L), L)
    return F.store_hi(L, 5)


# ---- gains --------------------------------------------------------------

def _ener_measure(a, prd_lt, code):
    """Ener_Measure: -> (ener_pit, ener_cod) (B,) Word16."""
    Lg = _lpc_gain(a)
    exp_lpc = F.norm_l(Lg)
    g_lpc = F.extract_h(F.L_shl(Lg, exp_lpc))

    one = jnp.ones(prd_lt.shape[:1], jnp.int32)
    L = _mac0_chain(one, prd_lt, prd_lt)
    exp_plt = F.norm_l(L)
    t16 = F.extract_h(F.L_shl(L, exp_plt))
    L = F.L_mult0(t16, g_lpc)
    exp_plt = F.add(exp_plt, exp_lpc)
    e16, frac = _log2(L)
    L = F.Load_sh16(e16)
    L = F.add_sh(L, frac, 1)
    L = F.sub_sh16(L, exp_plt)
    L = F.add_sh(L, 0x6AE, 8)
    ener_pit = F.extract_l(F.L_shr(L, 8))

    L = _mac0_chain(jnp.zeros_like(one), code, code)
    t16 = F.extract_h(L)
    L = F.L_mult0(t16, g_lpc)
    e16, frac = _log2(L)
    L = F.Load_sh16(e16)
    L = F.add_sh(L, frac, 1)
    L = F.sub_sh16(L, exp_lpc)
    L = F.sub_sh(L, 0x1152, 8)
    ener_cod = F.extract_l(F.L_shr(L, 8))
    return ener_pit, ener_cod


def _ener_update(index, last_pit, last_cod):
    L = F.Load_sh(last_pit, 8)
    L = F.add_sh(L, last_cod, 7)
    L = F.sub_sh(L, 0x300, 9)
    pred_pit = F.store_hi(jnp.maximum(L, 0), 7)
    L = F.Load_sh(last_cod, 8)
    L = F.add_sh(L, last_pit, 7)
    L = F.sub_sh(L, 0x300, 9)
    pred_cod = F.store_hi(jnp.maximum(L, 0), 7)
    q = jnp.take(jnp.asarray(T.T_QUA_ENER), index, axis=0)   # (B, 2)
    new_pit = F.add(q[:, 0], pred_pit)
    new_cod = F.add(q[:, 1], pred_cod)
    new_pit = jnp.where(F.sub(new_pit, 0x1B00) > 0, 0x1B00, new_pit)
    new_cod = jnp.where(F.sub(new_cod, 0x1900) > 0, 0x1900, new_cod)
    return new_pit, new_cod


def _ener_gains(last_pit, last_cod, ener_pit, ener_cod):
    L = F.Load_sh(last_pit, 6)
    L = F.sub_sh(L, ener_pit, 6)
    L = F.add_sh(L, 12, 15)
    e16, frac = F.L_extract(L)
    L = _pow2(e16, frac)
    gain_pit = F.extract_l(jnp.where(F.L_sub(L, 0x1333) > 0, 0x1333, L))
    L = F.Load_sh(last_cod, 6)
    L = F.sub_sh(L, ener_cod, 6)
    e16, frac = F.L_extract(L)
    gain_cod = F.extract_l(_pow2(e16, frac))
    return gain_pit, gain_cod


# ---- frame decode -------------------------------------------------------

def decode_frame(state: SpeechState, prm):
    """One 30 ms frame for every carrier.  prm (B, 24) int32 =
    [BFI, 23 parameters]; returns (new state, (B, 240) synth) —
    synth BEFORE Post_Process (matching tetra_etsi_decode_frame)."""
    bfi = prm[:, 0]
    parm = prm[:, 1:]
    isbfi = (bfi != 0)
    isbfi_c = isbfi[:, None]

    lsp_dec = _d_lsp334(parm[:, :3], state.lspold)
    lsp_conceal = jnp.concatenate(
        [state.lspnew[:, :1], state.lspold[:, 1:]], axis=1)
    lspnew = jnp.where(isbfi_c, lsp_conceal, lsp_dec)
    # the consumed parameter stream doubles as the next frame's
    # concealment source (C: parm = old_parm when BFI)
    p = jnp.where(isbfi_c, state.old_parm, parm)
    old_parm = p

    A_t = _int_lpc4(state.lspold, lspnew)            # (B, 44)
    lspold = lspnew

    buf = state.old_exc
    mem_syn = state.mem_syn
    t0 = state.old_t0
    frac = jnp.zeros_like(t0)
    t0_min = jnp.zeros_like(t0)
    t0_max = jnp.zeros_like(t0)
    last_pit = state.last_ener_pit
    last_cod = state.last_ener_cod
    parts = []

    for s in range(4):
        a = A_t[:, 11 * s: 11 * s + 11]
        index = p[:, 3 + 5 * s]

        if s == 0:
            le196 = F.sub(index, 196) <= 0
            tmp = F.mult(F.add(index, 2), 0x2AAB)
            t0_a = F.add(tmp, 19)
            tmp2 = F.sub(58, F.add(F.add(t0_a, t0_a), t0_a))
            frac_a = F.add(index, tmp2)
            t0_new = jnp.where(le196, t0_a, F.sub(index, 112))
            frac_new = jnp.where(le196, frac_a, 0)
            t0 = jnp.where(isbfi, state.old_t0, t0_new)
            frac = jnp.where(isbfi, 0, frac_new)
            t0_min = F.sub(t0, 5)
            t0_min = jnp.where(F.sub(t0_min, 19) <= 0, 20, t0_min)
            t0_max = F.add(t0_min, 9)
            over = F.sub(t0_max, 143) > 0
            t0_max = jnp.where(over, 143, t0_max)
            t0_min = jnp.where(over, F.sub(t0_max, 9), t0_min)
        else:
            tmp = F.sub(F.mult(F.add(index, 2), 0x2AAB), 1)
            t0_new = F.add(t0_min, tmp)
            tmp2 = F.add(F.add(F.add(tmp, tmp), tmp), 2)
            frac_new = F.sub(index, tmp2)
            t0 = jnp.where(isbfi, t0, t0_new)
            frac = jnp.where(isbfi, frac, frac_new)

        base = EXC_OFF + L_SUBFR * s
        buf = _pred_lt(buf, t0, frac, base)
        prd_lt = buf[:, base:base + L_SUBFR]

        ap3 = _pond_ai(a, F_GAMMA3)
        ap4 = _pond_ai(a, F_GAMMA4)
        h0 = jnp.concatenate(
            [ap3, jnp.zeros(a.shape[:1] + (L_SUBFR - 11,), jnp.int32)],
            axis=1)
        h, _ = _syn_filt(ap4, h0, jnp.zeros(a.shape[:1] + (10,),
                                            jnp.int32))
        h = _sharpen(h, t0)

        code = _d_d4i60(p[:, 4 + 5 * s], p[:, 5 + 5 * s],
                        p[:, 6 + 5 * s], h)

        ener_pit, ener_cod = _ener_measure(a, prd_lt, code)
        up_pit, up_cod = _ener_update(p[:, 7 + 5 * s], last_pit, last_cod)
        dn_pit = jnp.maximum(F.sub(last_pit, 128), 0)
        dn_cod = jnp.maximum(F.sub(last_cod, 128), 0)
        last_pit = jnp.where(isbfi, dn_pit, up_pit)
        last_cod = jnp.where(isbfi, dn_cod, up_cod)
        gain_pit, gain_cod = _ener_gains(last_pit, last_cod,
                                         ener_pit, ener_cod)

        L = F.L_mult0(gain_pit[:, None], prd_lt)
        L = F.L_mac0(L, gain_cod[:, None], code)
        exc_new = F.extract_l(F.L_shr_r(L, 12))      # (Word16) cast
        buf = buf.at[:, base:base + L_SUBFR].set(exc_new)

        y, mem_syn = _syn_filt(a, exc_new, mem_syn)
        parts.append(y)

    synth = jnp.concatenate(parts, axis=1)
    # Full EXC_OFF-word history shift: buf[EXC_OFF-1] == exc[-1] must be
    # this frame's last excitation sample (a 158-word shift left it one
    # frame stale — matching C++ fix in etsi_acelp_dec.cpp decode()).
    buf = buf.at[:, 0:EXC_OFF].set(buf[:, L_FRAME:L_FRAME + EXC_OFF])

    new_state = SpeechState(
        old_exc=buf, lspold=lspold, lspnew=lspnew, mem_syn=mem_syn,
        old_parm=old_parm, old_t0=t0,
        last_ener_pit=last_pit, last_ener_cod=last_cod)
    return new_state, synth


# ---- block API ----------------------------------------------------------

_B2P = T.bits2prm_matrix()


def bits2prm(frames):
    """(..., 138) [BFI + 137 serial bits] -> (..., 24) parameters."""
    bits = frames[..., 1:] & 1
    prm = bits @ jnp.asarray(_B2P)
    return jnp.concatenate([frames[..., :1], prm], axis=-1)


def decode_block(state: SpeechState, frames, valid):
    """Decode up to F frames per carrier in one jitted program.

    frames: (B, F, 138) int32 [BFI + 137 serial bits] per frame;
    valid:  (B, F) bool — invalid slots leave that carrier's state
    untouched and emit zeros (exactly as if the frame never arrived).
    Returns (new state, (B, F, 240) int32 PCM, Post_Process applied).
    """
    def step(st, fr_v):
        fr, v = fr_v
        new_st, synth = decode_frame(st, bits2prm(fr))
        st2 = jax.tree_util.tree_map(
            lambda n, o: jnp.where(
                v.reshape(v.shape + (1,) * (n.ndim - 1)), n, o),
            new_st, st)
        pcm = jnp.where(v[:, None], F.add(synth, synth), 0)
        return st2, pcm

    state, pcm = jax.lax.scan(
        step, state, (frames.transpose(1, 0, 2), valid.T))
    return state, pcm.transpose(1, 0, 2)


decode_block_jit = jax.jit(decode_block)
