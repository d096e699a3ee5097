"""Wavefront compaction for the staged wavefront's ray pack
(`renderers/_wavefront.build_staged_wavefront_fn`).

`shift_pack_channels` is the pack itself; `pack_indices` is the plain
cumsum + scatter form it is tested against.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import jax.numpy as jnp


def pack_indices(mask: jnp.ndarray, cap: int) -> jnp.ndarray:
    """Indices of the first `cap` True lanes of `mask`, n-filled past the
    last hit — bit-identical to `jnp.nonzero(mask, size=cap,
    fill_value=n)[0]`, which XLA lowers through a sort; this is one
    exclusive cumsum + one scatter.

    The result is sorted ascending, unique below n, and safe to use with
    `jnp.take(..., mode="clip")` + `.at[ridx].set(..., mode="drop",
    indices_are_sorted=True, unique_indices=True)` for the scatter-back.
    """
    n = mask.shape[0]
    pos = jnp.cumsum(mask.astype(jnp.int32)) - 1
    slot = jnp.where(mask & (pos < cap), pos, cap)
    return jnp.full((cap,), n, jnp.int32).at[slot].set(
        jnp.arange(n, dtype=jnp.int32), mode="drop")


def shift_pack_channels(mask: jnp.ndarray, channels: Sequence[jnp.ndarray],
                        cap: int) -> Tuple[Tuple[jnp.ndarray, ...],
                                           jnp.ndarray, jnp.ndarray]:
    """Stable stream compaction WITHOUT gathers, scatters, or sorts: move
    every masked lane of each `(n,)` channel to the front using log2(n)
    staged shift-selects (roll + where), which XLA lowers to plain
    slices/selects that stream through memory: ~log2(n) passes in place of
    a pack-scatter and one gather per channel.  Whether that beats
    cumsum + gather on the GPU is open (PERF.md).

    Why it is correct: hit j's target slot is pos[j] (its exclusive hit
    count), so its left-shift distance s_j = j - pos[j] is NON-DECREASING
    in j (pos grows by at most 1 per lane).  Processing shift bits
    LSB-first, an element moves 2^k at step k iff bit k of its total s is
    set; after step k every element has moved s mod 2^(k+1).  A collision
    (mover landing on a stationary element's slot) would need remaining
    shifts rem_X - rem_Y = 2^k - (pos_X - pos_Y) with rem ≡ 0 mod 2^k on
    both sides and bit k set only on X — i.e. a difference ≡ 2^k
    (mod 2^(k+1)) that is both < 2^k and >= 0 (monotonicity) — impossible.
    Slots a mover vacates keep a stale copy, but every slot < n_hit is
    eventually overwritten by its true hit, and slots >= n_hit are masked
    off by the caller.

    Returns `(packed_channels, ridx, n_hit)`: each packed channel sliced
    to `(cap,)` (slot p < n_hit holds channel[j] of the p-th hit; stale
    values past n_hit), `ridx` the source index per slot (n-filled past
    n_hit — same contract as `pack_indices`, sorted/unique/drop-safe for
    the scatter-back), and `n_hit` the total hit count (i32 scalar).
    """
    n = mask.shape[0]
    iota = jnp.arange(n, dtype=jnp.int32)
    pos = jnp.cumsum(mask.astype(jnp.int32)) - 1
    n_hit = pos[-1] + 1
    # left-shift distance; -1 marks non-hits (never a mover)
    s = jnp.where(mask, iota - pos, jnp.int32(-1))
    # per-channel 1D shift-selects: one streaming fusion per channel
    chans = list(channels)
    for k in range(max(1, (n - 1).bit_length())):
        step = 1 << k
        if step >= n:
            break
        mover = (s >= 0) & (((s >> k) & 1) == 1)
        landing = jnp.concatenate([mover[step:],
                                   jnp.zeros((step,), jnp.bool_)])

        def shsel(a, landing=landing, step=step):
            return jnp.where(landing,
                             jnp.concatenate([a[step:], a[:step]]), a)

        s = shsel(s)
        chans = [shsel(c) for c in chans]
    pslot = jnp.arange(cap, dtype=jnp.int32)
    valid = pslot < n_hit
    ridx = jnp.where(valid, pslot + s[:cap], n)
    return tuple(c[:cap] for c in chans), ridx, n_hit
