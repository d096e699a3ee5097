"""Golden-image tests against plain reference renders.

RayCast is deterministic, so it is checked pixel by pixel against a
straightforward float64 numpy ray caster written here from the reference's
semantics (`RayCastRenderer.cpp`, `intersections.cpp`, `Phong.cpp`), which
reads the parsed Scene directly.  SimplePathTracer is checked against the
megakernel's plain reference (`ops.pt_pallas.render_reference_linear`) at
equal spp: two independent realisations of one estimator."""
import numpy as np

import nrenderer_tpu
from nrenderer_tpu import load_scn

nrenderer_tpu._register_builtin_renderers()


def _camera_rays(cam, w, h):
    """Pinhole rays of the reference camera (`Camera.hpp:25-57`)."""
    pos = np.asarray(cam.position, float)
    wv = pos - np.asarray(cam.look_at, float)
    wv /= np.linalg.norm(wv)
    u = np.cross(np.asarray(cam.up, float), wv)
    u /= np.linalg.norm(u)
    v = np.cross(wv, u)
    hh = np.tan(np.radians(np.clip(cam.fov, 20.0, 160.0)) / 2.0)
    hw = cam.aspect * hh
    fd = cam.focus_distance
    ll = pos - hw * fd * u - hh * fd * v - fd * wv
    ii, jj = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    s = (jj / w)[..., None]
    t = (ii / h)[..., None]
    d = ll + s * 2 * hw * fd * u + t * 2 * hh * fd * v - pos
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return np.broadcast_to(pos, d.shape).copy(), d


def _objects(scene):
    """World-space (kind, data, material) list with model translations."""
    out = []
    for node in scene.nodes:
        tr = np.asarray(scene.models[node.model].translation, float)
        if node.type.name == "SPHERE":
            s = scene.sphere_buffer[node.entity]
            out.append(("sph", (np.asarray(s.position) + tr, s.radius),
                        s.material))
        elif node.type.name == "TRIANGLE":
            t = scene.triangle_buffer[node.entity]
            out.append(("tri", (np.asarray(t.v1) + tr, np.asarray(t.v2) + tr,
                                np.asarray(t.v3) + tr,
                                np.asarray(t.normal, float)), t.material))
        elif node.type.name == "PLANE":
            p = scene.plane_buffer[node.entity]
            out.append(("pln", (np.asarray(p.position) + tr,
                                np.asarray(p.u, float),
                                np.asarray(p.v, float),
                                np.asarray(p.normal, float)), p.material))
    return out


def _hit(objs, o, d, t_min):
    """Closest hit: (t, normal, material index), t = inf on a miss."""
    n_pix = o.shape[0]
    best = np.full(n_pix, np.inf)
    nrm = np.zeros((n_pix, 3))
    mat = np.full(n_pix, -1)
    for kind, data, m in objs:
        if kind == "sph":
            c, r = data
            oc = o - c
            b = (oc * d).sum(-1)
            disc = b * b - (oc * oc).sum(-1) + r * r
            sq = np.sqrt(np.maximum(disc, 0.0))
            t1, t2 = -b - sq, -b + sq
            t = np.where((disc > 0) & (t1 >= t_min), t1,
                         np.where((disc > 0) & (t2 >= t_min), t2, np.inf))
            n = (o + np.where(np.isfinite(t), t, 0.0)[:, None] * d - c) / r
        elif kind == "tri":
            v1, v2, v3, n_tri = data
            e1, e2 = v2 - v1, v3 - v1
            p = np.cross(d, e2)
            det0 = p @ e1
            sign = np.where(det0 > 0, 1.0, -1.0)
            det = det0 * sign
            tv = (o - v1) * sign[:, None]
            u = (tv * p).sum(-1)
            q = np.cross(tv, e1)
            v = (d * q).sum(-1)
            w = (q @ e2) / np.where(det == 0, 1.0, det)
            ok = ((det >= 1e-6) & (u >= 0) & (u <= det) & (v >= 0)
                  & (u + v <= det) & (w >= t_min))
            t = np.where(ok, w, np.inf)
            n = np.broadcast_to(n_tri, (n_pix, 3))
        else:
            pos, pu, pv, n_pl = data
            nd = d @ n_pl
            par = (nd < 1e-7) & (nd > -1e-8)
            t = ((pos @ n_pl) - o @ n_pl) / np.where(par, 1.0, nd)
            inv = np.linalg.inv(np.stack([pu, pv, np.cross(pu, pv)], 1))
            uv = (o + t[:, None] * d - pos) @ inv.T
            ok = (~par & (t >= t_min) & (uv[:, 0] >= 0) & (uv[:, 0] <= 1)
                  & (uv[:, 1] >= 0) & (uv[:, 1] <= 1))
            t = np.where(ok, t, np.inf)
            n = np.broadcast_to(n_pl, (n_pix, 3))
        closer = t < best
        best = np.where(closer, t, best)
        nrm = np.where(closer[:, None], n, nrm)
        mat = np.where(closer, m, mat)
    return best, nrm, mat


def _raycast_reference(scene, w, h):
    """(H, W, 3) image, row 0 = top: one point light, shadow ray with
    epsilon 0.01, Lambert (type 0) or Phong (type 1), clamp, sqrt gamma."""
    o, d = _camera_rays(scene.camera, w, h)
    o, d = o.reshape(-1, 3), d.reshape(-1, 3)
    objs = _objects(scene)
    t, n, mat = _hit(objs, o, d, 0.01)
    n = n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)
    p = o + np.where(np.isfinite(t), t, 0.0)[:, None] * d
    light = scene.point_light_buffer[0]
    to_l = np.asarray(light.position, float) - p
    dist = np.linalg.norm(to_l, axis=-1)
    out = to_l / dist[:, None]
    ts, _, _ = _hit(objs, p, out, 0.01)
    lit = np.isfinite(t) & ((out * n).sum(-1) > 0) & ~(ts <= dist)

    def prop(m, key, default):
        v = scene.materials[m].get_property(key)
        return np.asarray(default if v is None else v, float)

    col = np.zeros_like(p)
    for m in set(mat[lit].tolist()):
        sel = lit & (mat == m)
        cos = (out[sel] * n[sel]).sum(-1)
        c = prop(m, "diffuseColor", (1, 1, 1)) * cos[:, None]
        if scene.materials[m].type == 1:
            r = out[sel] - 2 * cos[:, None] * n[sel]
            vr = np.abs((-d[sel] * r).sum(-1))
            spec = np.maximum(vr, 1e-30) ** prop(m, "specularEx", 1.0)
            c = c + prop(m, "specularColor", (1, 1, 1)) * spec[:, None]
        col[sel] = c * np.asarray(light.intensity, float)
    img = np.sqrt(np.clip(col, 0.0, 1.0)).reshape(h, w, 3)
    return img[::-1]


def test_raycast_matches_plain_reference(resource_dir):
    from nrenderer_tpu.renderers.raycast import RayCastRenderer
    scene = load_scn(str(resource_dir / "ray_cast_cornel.scn"))
    w = h = 96
    scene.render_option.width, scene.render_option.height = w, h
    img = RayCastRenderer().render(scene).pixels[..., :3]
    ref = _raycast_reference(scene, w, h)
    diff = np.abs(img - ref).max(axis=-1)
    # float32 against float64: only silhouette and shadow-edge pixels may
    # fall on the other side of an edge
    assert (diff > 0.02).mean() < 0.01, (diff > 0.02).mean()
    assert abs(img.mean() - ref.mean()) < 0.005
    assert ref.max() > 0.3  # the reference itself lit the scene


def test_pt_cornell_tracks_plain_reference(resource_dir):
    """SimplePathTracer (jax.random XLA wavefront) against the hash-RNG
    plain reference at equal spp: same estimator, independent streams."""
    from nrenderer_tpu.ops import pt_pallas
    from nrenderer_tpu.ops.camera import make_camera
    from nrenderer_tpu.ops.intersect import make_static_scene
    from nrenderer_tpu.renderers.simple_pt import SimplePathTracerRenderer
    from nrenderer_tpu.scene.arrays import build_scene_arrays
    scene = load_scn(str(resource_dir / "path_tracing_cornel.scn"))
    w = h = 48
    spp, depth = 64, 8
    ro = scene.render_option
    ro.width, ro.height, ro.samples_per_pixel, ro.depth = w, h, spp, depth
    img = SimplePathTracerRenderer().render(scene).pixels[..., :3]
    ss = make_static_scene(build_scene_arrays(scene))
    lin = pt_pallas.render_reference_linear(ss, make_camera(scene.camera),
                                            w, h, spp, depth, seed=1)
    ref = np.sqrt(np.maximum(np.asarray(lin) / spp, 0.0)).reshape(h, w, 3)
    ref = np.clip(ref[::-1], 0.0, 1.0)
    assert abs(img.mean() - ref.mean()) < 0.02
    # structure: walls, light and shadows line up (block means)
    a = img.reshape(6, 8, 6, 8, 3).mean(axis=(1, 3)).reshape(-1)
    b = ref.reshape(6, 8, 6, 8, 3).mean(axis=(1, 3)).reshape(-1)
    assert np.corrcoef(a, b)[0, 1] > 0.9
