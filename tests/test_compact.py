"""ops/compact.pack_indices: bit-equality with jnp.nonzero(size, fill)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nrenderer_tpu.ops.compact import pack_indices, shift_pack_channels


@pytest.mark.parametrize("frac", [0.0, 0.05, 0.5, 1.0])
@pytest.mark.parametrize("cap", [16, 128, 1000])
def test_matches_nonzero(frac, cap):
    n = 1000
    mask = jax.random.uniform(jax.random.PRNGKey(7), (n,)) < frac
    (want,) = jnp.nonzero(mask, size=cap, fill_value=n)
    got = pack_indices(mask, cap)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_scatter_roundtrip_under_jit():
    """The documented consumer pattern: gather by the pack, transform,
    scatter back with the sorted/unique hints — identity on packed lanes,
    fill elsewhere."""
    n, cap = 512, 64
    mask = jax.random.uniform(jax.random.PRNGKey(3), (n,)) < 0.08
    vals = jnp.arange(n, dtype=jnp.float32) * 2.0

    @jax.jit
    def roundtrip(mask, vals):
        ridx = pack_indices(mask, cap)
        g = jnp.clip(ridx, 0, n - 1)
        packed = jnp.take(vals, g, mode="clip")
        return jnp.full((n,), -1.0).at[ridx].set(
            packed, mode="drop", indices_are_sorted=True,
            unique_indices=True)

    out = np.asarray(roundtrip(mask, vals))
    m = np.asarray(mask)
    np.testing.assert_array_equal(out[m], np.asarray(vals)[m])
    assert (out[~m] == -1.0).all()


@pytest.mark.parametrize("frac", [0.0, 0.03, 0.2, 0.5, 1.0])
@pytest.mark.parametrize("n,cap", [(1000, 128), (1000, 1000), (4096, 512),
                                   (127, 16), (1, 1)])
def test_shift_pack_matches_gather_pack(frac, n, cap):
    """shift_pack_channels == pack_indices + per-channel gather, on the
    valid prefix, including the overflow (n_hit > cap) case; ridx matches
    pack_indices bit-exactly over the whole cap (n-filled tails)."""
    key = jax.random.PRNGKey(int(frac * 100) + n)
    mask = jax.random.uniform(key, (n,)) < frac
    k1, k2 = jax.random.split(key)
    ch_a = jax.random.normal(k1, (n,))
    ch_b = jnp.arange(n, dtype=jnp.int32) * 3 - 7
    ch_c = jax.random.normal(k2, (n,)) * 1e6

    @jax.jit
    def both(mask, a, b, c):
        ridx_ref = pack_indices(mask, cap)
        g = jnp.clip(ridx_ref, 0, n - 1)
        ref = tuple(jnp.take(x, g, mode="clip") for x in (a, b, c))
        packed, ridx, n_hit = shift_pack_channels(mask, (a, b, c), cap)
        return ridx_ref, ref, packed, ridx, n_hit

    ridx_ref, ref, packed, ridx, n_hit = both(mask, ch_a, ch_b, ch_c)
    n_hit = int(n_hit)
    assert n_hit == int(np.asarray(mask).sum())
    np.testing.assert_array_equal(np.asarray(ridx), np.asarray(ridx_ref))
    v = min(n_hit, cap)
    for got, want in zip(packed, ref):
        np.testing.assert_array_equal(np.asarray(got)[:v],
                                      np.asarray(want)[:v])


def test_shift_pack_edge_positions():
    """Single hits at the extreme lanes land in slot 0."""
    n, cap = 300, 8
    vals = jnp.arange(n, dtype=jnp.float32)
    for j in (0, 1, n - 2, n - 1):
        mask = jnp.zeros((n,), jnp.bool_).at[j].set(True)
        packed, ridx, n_hit = shift_pack_channels(mask, (vals,), cap)
        assert int(n_hit) == 1
        assert int(ridx[0]) == j
        assert float(packed[0][0]) == float(j)
        assert (np.asarray(ridx)[1:] == n).all()
