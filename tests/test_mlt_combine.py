"""Equivalence test for the round-4 factorized `MLTKernel.combine_paths`.

`_combine_ref` below is the round-2/3 implementation (per-L recomputation of
all edge physics on the materialized combined path) kept verbatim as the
ground truth; the shipped version factorizes per-edge physics into per-sample
tables + an (s, t) connection grid.  Per-edge values are
bit-identical by construction; the throughput product changes multiplication
ORDER only, so outputs agree to f32 reassociation tolerance."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from nrenderer_tpu import load_scn
from nrenderer_tpu.renderers.mlt import (
    LIGHT_ID, MIN_PATH_LENGTH, PI, T_MIN, _prepare_mlt,
)
from nrenderer_tpu.ops.intersect import intersect_scene_unrolled
from nrenderer_tpu.ops.soa import V3, normalize3, where3


def _combine_ref(self, eye, light, wh=None):
    """Round-2/3 combine_paths, verbatim (see module docstring)."""
    v = self.v_max
    c = eye.px.shape[1]
    cam = self.cam
    w_, h_ = wh if wh is not None else (float(self.width),
                                        float(self.height))
    dist = h_ / (2.0 * cam.half_height)
    rows = np.arange(v)

    n_eye = eye.count
    n_light = light.count
    d_cam = normalize3(V3(eye.px[1] - eye.px[0], eye.py[1] - eye.py[0],
                          eye.pz[1] - eye.pz[0]), eps=1e-20)
    ddw_c = (d_cam.x * -cam.w[0] + d_cam.y * -cam.w[1]
             + d_cam.z * -cam.w[2])
    k_c = dist / jnp.where(jnp.abs(ddw_c) < 1e-12, 1e-12, ddw_c)
    spx_c = d_cam.x * k_c + cam.w[0] * dist
    spy_c = d_cam.y * k_c + cam.w[1] * dist
    spz_c = d_cam.z * k_c + cam.w[2] * dist
    px_cam = (cam.u[0] * spx_c + cam.u[1] * spy_c + cam.u[2] * spz_c
              + w_ * 0.5)
    py_cam = (-cam.v[0] * spx_c - cam.v[1] * spy_c - cam.v[2] * spz_c
              + h_ * 0.5)

    outs = []
    red_r = jnp.zeros((c,))
    red_g = jnp.zeros((c,))
    red_b = jnp.zeros((c,))
    red_any = jnp.zeros((c,), jnp.bool_)
    sc = jnp.zeros((c,))
    for L in range(MIN_PATH_LENGTH, self.max_path + 1):
        s_arr = np.arange(1, L + 2)
        t_arr = (L + 1) - s_arr
        g = len(s_arr)

        ok0 = ((s_arr[:, None] <= n_eye[None, :])
               & (t_arr[:, None] <= n_light[None, :]))

        light_ridx = np.clip(L - rows, 0, v - 1)
        use_eye = (rows[:, None] < s_arr[None, :])[:, :, None]
        mk = lambda e, l: jnp.where(use_eye, e[:, None, :],
                                    l[light_ridx][:, None, :])
        cp_px, cp_py, cp_pz = mk(eye.px, light.px), mk(eye.py, light.py), \
            mk(eye.pz, light.pz)
        cp_nx, cp_ny, cp_nz = mk(eye.nx, light.nx), mk(eye.ny, light.ny), \
            mk(eye.nz, light.nz)
        cp_pid = mk(eye.pid, light.pid)
        cp_cr, cp_cg, cp_cb = mk(eye.cr, light.cr), mk(eye.cg, light.cg), \
            mk(eye.cb, light.cb)

        e_idx = s_arr - 1
        l_idx = np.clip(t_arr - 1, 0, v - 1)
        e_p = V3(eye.px[e_idx], eye.py[e_idx], eye.pz[e_idx])
        l_p = V3(light.px[l_idx], light.py[l_idx], light.pz[l_idx])
        s1 = (s_arr == 1)[:, None]
        origin = where3(s1, V3(jnp.full((g, c), cam.pos[0]),
                               jnp.full((g, c), cam.pos[1]),
                               jnp.full((g, c), cam.pos[2])), e_p)
        conn = V3(l_p.x - origin.x, l_p.y - origin.y, l_p.z - origin.z)
        conn_d = normalize3(conn, eps=1e-20)
        shadow = intersect_scene_unrolled(self.ss, origin, conn_d,
                                          t_min=T_MIN)
        vis = jnp.where((t_arr == 0)[:, None],
                        eye.pid[e_idx] == LIGHT_ID,
                        shadow.valid
                        & (shadow.prim_id == light.pid[l_idx]))

        direction = where3(s1, conn_d,
                           V3(d_cam.x[None, :], d_cam.y[None, :],
                              d_cam.z[None, :]))
        ddw = (direction.x * -cam.w[0] + direction.y * -cam.w[1]
               + direction.z * -cam.w[2])
        k = dist / jnp.where(jnp.abs(ddw) < 1e-12, 1e-12, ddw)
        spx = direction.x * k + cam.w[0] * dist
        spy = direction.y * k + cam.w[1] * dist
        spz = direction.z * k + cam.w[2] * dist
        px = (cam.u[0] * spx + cam.u[1] * spy + cam.u[2] * spz
              + w_ * 0.5)
        py = (-cam.v[0] * spx - cam.v[1] * spy - cam.v[2] * spz
              + h_ * 0.5)
        vis = vis & (px >= 0) & (px < w_) & (py >= 0) & (py < h_)

        dvx = cp_px[1:] - cp_px[:-1]
        dvy = cp_py[1:] - cp_py[:-1]
        dvz = cp_pz[1:] - cp_pz[:-1]
        d2 = dvx * dvx + dvy * dvy + dvz * dvz
        d2s = jnp.where(d2 < 1e-20, 1e-20, d2)
        inv_len = jax.lax.rsqrt(d2s)
        dup = d2 == 0.0

        cos0 = -(dvx[0] * cam.w[0] + dvy[0] * cam.w[1]
                 + dvz[0] * cam.w[2]) * inv_len[0]
        ds2 = (dist / jnp.where(jnp.abs(cos0) < 1e-12, 1e-12, cos0)) ** 2
        w_cam = (1.0 / (w_ * h_)) / (cos0 / ds2)
        cosn1 = jnp.abs((dvx[0] * cp_nx[1] + dvy[0] * cp_ny[1]
                         + dvz[0] * cp_nz[1]) * inv_len[0])
        f0 = w_cam * cosn1 / d2s[0]
        cos_i = (cp_nx[:-1] * dvx + cp_ny[:-1] * dvy
                 + cp_nz[:-1] * dvz)
        geo = (cos_i * cos_i) / (d2s * d2s)
        v_mid = rows[1:v - 1]
        g_mid = geo[1:v - 1]
        ok_mid = (jnp.isfinite(g_mid) & (g_mid > 1e-30)
                  & (v_mid < L)[:, None, None])
        m_r = jnp.where(ok_mid, cp_cr[1:v - 1] * (1.0 / PI) * g_mid, 1.0)
        m_g = jnp.where(ok_mid, cp_cg[1:v - 1] * (1.0 / PI) * g_mid, 1.0)
        m_b = jnp.where(ok_mid, cp_cb[1:v - 1] * (1.0 / PI) * g_mid, 1.0)
        f_r = f0 * jnp.prod(m_r, axis=0)
        f_g = f0 * jnp.prod(m_g, axis=0)
        f_b = f0 * jnp.prod(m_b, axis=0)
        is_light_end = cp_pid[L] == LIGHT_ID
        f_r = f_r * jnp.where(is_light_end, self.emitted[0] / PI, 0.0)
        f_g = f_g * jnp.where(is_light_end, self.emitted[1] / PI, 0.0)
        f_b = f_b * jnp.where(is_light_end, self.emitted[2] / PI, 0.0)

        d2a_fwd = jnp.abs(cp_nx[1:] * dvx + cp_ny[1:] * dvy
                          + cp_nz[1:] * dvz) * inv_len / d2s
        eye_t0 = ((1.0 / (w_ * h_)) / (cos0 / ds2)) * d2a_fwd[0]
        pdf_fwd = (jnp.abs(cp_nx[:-1] * dvx + cp_ny[:-1] * dvy
                           + cp_nz[:-1] * dvz) * inv_len) / PI
        eye_terms = jnp.concatenate(
            [eye_t0[None], jnp.where(dup[1:] | dup[:-1], 1.0,
                                     pdf_fwd[1:] * d2a_fwd[1:])])
        eye_prefix = jnp.concatenate(
            [jnp.ones((1, g, c)), jnp.cumprod(eye_terms, axis=0)])

        d2a_bwd = jnp.abs(cp_nx[:-1] * dvx + cp_ny[:-1] * dvy
                          + cp_nz[:-1] * dvz) * inv_len / d2s
        pdf_bwd = (jnp.abs(cp_nx[1:] * dvx + cp_ny[1:] * dvy
                           + cp_nz[1:] * dvz) * inv_len) / PI
        eL = int(np.clip(L - 1, 0, v - 2))
        lt1 = pdf_bwd[eL] * d2a_bwd[eL]
        idx_i = np.clip(L - rows - 1, 0, v - 2)
        lt_i = jnp.where(dup[idx_i] | dup[np.clip(L - rows, 0, v - 2)],
                         1.0, pdf_bwd[idx_i] * d2a_bwd[idx_i])
        light_terms = jnp.concatenate(
            [jnp.full((1, g, c), 1.0 / self.light_area), lt1[None],
             lt_i[1:v - 1]])
        light_prefix = jnp.concatenate(
            [jnp.ones((1, g, c)), jnp.cumprod(light_terms, axis=0)])

        sprime = rows + 1
        tprime = (L + 1) - sprime
        valid_split = (tprime >= 0) & (sprime <= L + 1)
        p_eye_all = eye_prefix[np.clip(sprime - 1, 0, v - 1)]
        p_light_all = light_prefix[np.clip(tprime, 0, v)]
        p_split = jnp.where(valid_split[:, None, None],
                            p_eye_all * p_light_all, 0.0)
        p_all = jnp.sum(p_split, axis=0)
        gi = np.arange(g)
        p_st = (eye_prefix[np.clip(s_arr - 1, 0, v - 1), gi]
                * light_prefix[np.clip(t_arr, 0, v), gi])

        w_mis = jnp.where((p_st > 0) & (p_all > 0),
                          jnp.clip(p_st / p_all, 0.0, 1.0), 0.0)

        inv_p = jnp.where(p_st > 0, 1.0 / p_st, 0.0)
        cr = f_r * w_mis * inv_p
        cg = f_g * w_mis * inv_p
        cb = f_b * w_mis * inv_p
        cmax = jnp.maximum(cr, jnp.maximum(cg, cb))
        valid = (ok0 & vis & (w_mis > 0) & (p_st > 0) & (cmax > 0)
                 & jnp.isfinite(cmax))
        cr = jnp.where(valid, cr, 0.0)
        cg = jnp.where(valid, cg, 0.0)
        cb = jnp.where(valid, cb, 0.0)
        sc = jnp.maximum(sc, jnp.max(jnp.where(valid, cmax, 0.0), axis=0))
        outs.append((px[0], py[0], cr[0], cg[0], cb[0], valid[0]))
        red_r = red_r + jnp.sum(cr[1:], axis=0)
        red_g = red_g + jnp.sum(cg[1:], axis=0)
        red_b = red_b + jnp.sum(cb[1:], axis=0)
        red_any = red_any | jnp.any(valid[1:], axis=0)

    outs.append((px_cam, py_cam, red_r, red_g, red_b, red_any))
    contribs = tuple(jnp.stack([o[i] for o in outs]) for i in range(6))
    return contribs, sc


@pytest.mark.parametrize("depth,chains,seed", [(6, 64, 0), (12, 48, 1),
                                               (20, 32, 2)])
def test_combine_matches_reference(resource_dir, depth, chains, seed):
    scene = load_scn(str(resource_dir / "Metropolis.scn"))
    scene.render_option.width = 64
    scene.render_option.height = 48
    kern, _, _ = _prepare_mlt(scene, max_path=depth)

    u = jax.random.uniform(jax.random.PRNGKey(seed),
                           (kern.n_states, chains))
    eye = kern.generate_eye_path(u)
    light = kern.generate_light_path(u)

    new_c, new_sc = jax.jit(kern.combine_paths)(eye, light)
    ref_c, ref_sc = jax.jit(lambda e, l: _combine_ref(kern, e, l))(eye,
                                                                   light)

    # only VALID rows carry meaning: the garbage values at invalid rows
    # legitimately differ between the two formulations
    ref_valid = np.asarray(ref_c[5])
    new_valid = np.asarray(new_c[5])
    np.testing.assert_array_equal(new_valid, ref_valid)
    for i in range(5):  # px, py, cr, cg, cb
        a = np.where(ref_valid, np.asarray(new_c[i]), 0.0)
        b = np.where(ref_valid, np.asarray(ref_c[i]), 0.0)
        np.testing.assert_allclose(a, b, rtol=2e-3, atol=1e-9,
                                   err_msg=f"contrib channel {i}")
    np.testing.assert_allclose(np.asarray(new_sc), np.asarray(ref_sc),
                               rtol=2e-3, atol=1e-9)
    # and the chains produce genuine contributions at this config
    assert ref_valid.any()
