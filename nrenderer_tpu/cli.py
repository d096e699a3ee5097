"""Command-line interface.

The reference is a GUI app (GLFW+ImGui); this rebuild is headless:

    python -m nrenderer_tpu list-renderers
    python -m nrenderer_tpu render --scene cornel.scn --renderer SimplePathTracer \
        --spp 2048 --width 512 --height 512 --out out.png
    python -m nrenderer_tpu render --scene x.scn --obj bunny.obj ...

Render settings defaults mirror the UI's `RenderSettingsManager.hpp:20-24`
(500x500, spp=16, depth=20); the camera defaults mirror `Camera.hpp:22-29`.
"""
from __future__ import annotations

import argparse
import logging
import os
import sys
import time

import numpy as np


def _build_scene(args):
    from .scene.model import Scene
    from .io.scn import load_scn
    from .io.obj import load_obj

    scene = Scene()
    if args.scene:
        load_scn(args.scene, scene)
    if args.obj:
        for obj_path in args.obj:
            load_obj(obj_path, scene,
                     material=0 if scene.materials else None)
    ro = scene.render_option
    ro.width = args.width
    ro.height = args.height
    ro.depth = args.depth
    ro.samples_per_pixel = args.spp
    # global microfacet knobs (reference RenderSettingsManager.hpp:15-17);
    # None = unset, per-material properties win (scene/model.RenderOption)
    if getattr(args, "roughness", None) is not None:
        ro.roughness = args.roughness
    if getattr(args, "f0", None) is not None:
        ro.f0 = args.f0
    if getattr(args, "metalness", None) is not None:
        ro.metalness = args.metalness
    cam = scene.camera
    if args.camera_position:
        cam.position = tuple(args.camera_position)
    if args.camera_look_at:
        cam.look_at = tuple(args.camera_look_at)
    if args.fov is not None:
        cam.fov = args.fov
    if args.aperture is not None:
        cam.aperture = args.aperture
    if args.ambient:
        scene.ambient.constant = tuple(args.ambient)
    if args.env_map:
        from .io.image import ImageDecodeError
        from .resources import attach_env_map
        try:
            attach_env_map(scene, args.env_map)
        except ImageDecodeError as exc:
            raise SystemExit(f"cannot decode env map: {exc}") from exc
    return scene


def _cmd_render(args) -> int:
    import nrenderer_tpu
    nrenderer_tpu._register_builtin_renderers()
    from .server.manager import ComponentManager
    from .server.registry import get_server
    from .io.image import write_png

    from .server.registry import UnknownComponentError
    from .io.scn import ScnParseError
    from .io.obj import ObjParseError

    try:
        scene = _build_scene(args)
    except (ScnParseError, ObjParseError) as exc:
        print(f"error: scene import failed: {exc}", file=sys.stderr)
        return 2

    if args.devices > 1 and args.renderer in (
            "SimplePathTracer", "AccPathTracer", "MetropolisLightTransport"):
        return _render_multichip(args, scene)

    component = None
    if args.renderer == "MetropolisLightTransport" and (
            args.chains or args.mutations or args.checkpoint):
        from .renderers.mlt import MetropolisRenderer
        component = MetropolisRenderer(seed=args.seed, chains=args.chains,
                                       mutations=args.mutations,
                                       checkpoint_path=args.checkpoint)
    elif args.renderer == "SimplePathTracer" and (args.progressive
                                                  or args.checkpoint
                                                  or args.serve is not None):
        from .renderers.simple_pt import SimplePathTracerRenderer
        component = SimplePathTracerRenderer(
            seed=args.seed, checkpoint_path=args.checkpoint,
            progressive=True)
    elif args.renderer == "AccPathTracer" and args.checkpoint:
        from .renderers.acc_pt import AccPathTracerRenderer
        component = AccPathTracerRenderer(
            seed=args.seed, checkpoint_path=args.checkpoint)

    mgr = ComponentManager()
    viewer = None
    if args.serve is not None:
        # live viewer: the headless ScreenView analogue —
        # watch progressive previews refresh in a browser while the render
        # runs (reference ScreenView.cpp:98-178)
        # MLT mid-render Screen posts only when someone is watching: each
        # preview flushes the async block pipeline and fetches the film,
        # so the default is off and --serve turns it on (explicit env wins
        # either way)
        os.environ.setdefault("NR_MLT_PREVIEW_BLOCKS", "1")
        from .server.viewer import ScreenViewer
        viewer = ScreenViewer(get_server().screen, port=args.serve,
                              state_fn=lambda: mgr.state.name).start()
        print(f"live view: {viewer.url}", file=sys.stderr)
    t0 = time.perf_counter()
    try:
        mgr.exec(args.renderer, scene, component=component)
    except UnknownComponentError:
        names = ", ".join(
            i.name for i in
            get_server().component_factory.get_components_info("Render"))
        print(f"error: unknown renderer {args.renderer!r}; "
              f"available: {names}", file=sys.stderr)
        return 2
    result = mgr.wait()
    wall = time.perf_counter() - t0
    if result is None:
        if viewer is not None:
            viewer.stop()
        print("render failed", file=sys.stderr)
        return 1
    write_png(args.out, result.pixels)
    n_rays = args.width * args.height * max(1, args.spp)
    print(f"{args.renderer}: {args.width}x{args.height} spp={args.spp} "
          f"depth={args.depth} in {wall:.2f}s "
          f"({n_rays / wall / 1e6:.1f} Mpaths/s) -> {args.out}")
    return _serve_tail(viewer, result.pixels)


def _render_multichip(args, scene) -> int:
    """Render sharded over N local devices (parallel/, SURVEY §2.9):
    SimplePathTracer / AccPathTracer shard the sample budget,
    MetropolisLightTransport shards the Markov-chain axis."""
    import time as _time
    import numpy as np
    import jax
    from .scene.arrays import build_scene_arrays
    from .ops.camera import make_camera
    from .ops.intersect import make_static_scene
    from .parallel.mesh import make_mesh
    from .io.image import write_png

    n_dev = len(jax.devices())
    if args.devices > n_dev:
        print(f"error: {args.devices} devices requested, {n_dev} available",
              file=sys.stderr)
        return 2
    mesh = make_mesh(args.devices)
    viewer = None
    if args.serve is not None:
        from .server.registry import get_server
        from .server.viewer import ScreenViewer
        viewer = ScreenViewer(get_server().screen, port=args.serve).start()
        print(f"live view: {viewer.url}", file=sys.stderr)
    if args.shard == "pixels" and args.renderer not in (
            "SimplePathTracer", "AccPathTracer"):
        # pixel-band decomposition needs a per-pixel estimator; MLT splats
        # across the whole film, so don't silently substitute a different
        # decomposition for the one the user explicitly asked for
        print(f"error: --shard pixels supports SimplePathTracer / "
              f"AccPathTracer only (got {args.renderer}); "
              f"use --shard samples", file=sys.stderr)
        return 2
    if args.shard == "pixels" and args.height % args.devices:
        print(f"error: --shard pixels needs height divisible by "
              f"--devices ({args.height} % {args.devices} != 0)",
              file=sys.stderr)
        return 2
    t0 = _time.perf_counter()
    if args.renderer == "MetropolisLightTransport":
        from .parallel.mlt import render_mlt_sharded
        chains = args.chains or 4096
        mutations = args.mutations or 256
        rgba = render_mlt_sharded(scene, chains=chains, mutations=mutations,
                                  seed=args.seed, mesh=mesh,
                                  checkpoint_path=args.checkpoint)
        wall = _time.perf_counter() - t0
        write_png(args.out, rgba)
        print(f"MetropolisLightTransport[{args.devices} devices]: "
              f"{args.width}x{args.height} {chains}x{mutations} mutations "
              f"in {wall:.2f}s -> {args.out}")
        return _serve_tail(viewer, rgba)

    arrays = build_scene_arrays(scene)
    ss = make_static_scene(arrays)
    cam = make_camera(scene.camera)
    if args.checkpoint or args.progressive or args.serve is not None:
        # host-chunked sharded render: checkpoint/resume + progressive
        # previews compose with --devices
        from .server.registry import get_server
        from .parallel.mesh import render_multichip_resumable
        fp_parts = [args.renderer, args.depth]
        fp_arrays = ()
        if args.renderer == "AccPathTracer":
            from .ops.pt_core import make_mat_channels
            from .renderers.acc_pt import trace_bsdf_wavefront
            tri_bvh = None
            n_tri = int(np.asarray(arrays.tri_valid).sum())
            textures = arrays.textures if ss.tri_uv else None
            if n_tri > 64:
                from .ops.bvh import build_mesh_engine
                tri_bvh = build_mesh_engine(arrays, make_mat_channels(ss))
            env_map = arrays.env_map if ss.ambient_type == 1 else None
            fp_parts += [ss, bool(tri_bvh), bool(env_map)]
            fp_arrays = (((np.asarray(arrays.env_map),) if env_map is not None
                          else ()) + tuple(textures or ()))

            def trace(o, d, key):
                return trace_bsdf_wavefront(ss, o, d, key, args.depth,
                                            env_map=env_map, tri_bvh=tri_bvh,
                                            textures=textures)
        else:
            from .renderers.simple_pt import trace_diffuse_wavefront
            fp_parts += [ss]

            def trace(o, d, key):
                return trace_diffuse_wavefront(ss, o, d, key, args.depth)

        img = render_multichip_resumable(
            trace, cam, args.width, args.height, args.spp, mesh,
            seed=args.seed, shard=args.shard,
            checkpoint_path=args.checkpoint,
            fingerprint_parts=tuple(fp_parts),
            fingerprint_arrays=fp_arrays,
            screen=get_server().screen)[::-1]
        wall = _time.perf_counter() - t0
        write_png(args.out, np.clip(img, 0.0, 1.0))
        print(f"{args.renderer}[{args.devices} devices, resumable]: "
              f"{args.width}x{args.height} spp={args.spp} in {wall:.2f}s "
              f"-> {args.out}")
        return _serve_tail(viewer, img)
    if args.renderer == "AccPathTracer":
        from .ops.pt_core import make_mat_channels
        from .parallel.mesh import render_multichip_acc
        tri_bvh = None
        n_tri = int(np.asarray(arrays.tri_valid).sum())
        # the same mesh engine as the single-device renderer
        textures = arrays.textures if ss.tri_uv else None
        if n_tri > 64:
            from .ops.bvh import build_mesh_engine
            tri_bvh = build_mesh_engine(arrays, make_mat_channels(ss))
        env_map = arrays.env_map if ss.ambient_type == 1 else None
        if args.shard == "pixels":
            import jax.numpy as jnp
            from .parallel.mesh import build_sharded_render_acc_pixels
            fn = build_sharded_render_acc_pixels(
                ss, args.width, args.height, args.spp, args.depth, mesh,
                tri_bvh=tri_bvh, env_map=env_map, textures=textures)
            seeds = jnp.arange(args.seed, args.seed + args.devices,
                               dtype=jnp.int32)
            img = np.asarray(fn(cam, seeds))[::-1]
        else:
            img = np.asarray(render_multichip_acc(
                ss, cam, args.width, args.height, args.spp, args.depth,
                mesh=mesh, seed=args.seed, tri_bvh=tri_bvh,
                env_map=env_map, textures=textures))[::-1]
    elif args.shard == "pixels":
        import jax.numpy as jnp
        from .parallel.mesh import build_sharded_render_pixels
        fn = build_sharded_render_pixels(ss, args.width, args.height,
                                         args.spp, args.depth, mesh)
        seeds = jnp.arange(args.seed, args.seed + args.devices,
                           dtype=jnp.int32)
        img = np.asarray(fn(cam, seeds))[::-1]
    else:
        from .parallel.mesh import render_multichip
        img = np.asarray(render_multichip(
            ss, cam, args.width, args.height, args.spp, args.depth,
            mesh=mesh, seed=args.seed))[::-1]
    wall = _time.perf_counter() - t0
    write_png(args.out, np.clip(img, 0.0, 1.0))
    print(f"{args.renderer}[{args.devices} devices]: "
          f"{args.width}x{args.height} spp={args.spp} in {wall:.2f}s "
          f"-> {args.out}")
    return _serve_tail(viewer, img)


def _serve_tail(viewer, final_img) -> int:
    """Post the finished frame to the live viewer (if any) and keep serving
    until interrupted — the reference UI keeps its result panel open too."""
    if viewer is None:
        return 0
    from .server.registry import get_server
    img = np.clip(np.asarray(final_img, np.float32), 0.0, 1.0)
    get_server().screen.set(img, img.shape[1], img.shape[0])
    print(f"serving final frame at {viewer.url} (Ctrl-C to exit)",
          file=sys.stderr)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        pass
    viewer.stop()
    return 0


def _cmd_edit(args) -> int:
    """Interactive edit-and-re-render loop: the headless AssetView
    (reference `AssetView.cpp:158-641` — edit camera/materials/entities/
    lights in a panel, then re-render).  Serves the editor page + live
    frame; every applied edit re-renders and refreshes the browser."""
    import nrenderer_tpu
    nrenderer_tpu._register_builtin_renderers()
    from .server.manager import ComponentManager
    from .server.registry import UnknownComponentError, get_server
    from .server.editor import SceneEditor
    from .server.viewer import ScreenViewer
    from .io.image import write_png
    from .io.scn import ScnParseError
    from .io.obj import ObjParseError

    try:
        scene = _build_scene(args)
    except (ScnParseError, ObjParseError) as exc:
        print(f"error: scene import failed: {exc}", file=sys.stderr)
        return 2

    known = {i.name for i in
             get_server().component_factory.get_components_info("Render")}
    if args.renderer not in known:
        print(f"error: unknown renderer {args.renderer!r}; "
              f"available: {', '.join(sorted(known))}", file=sys.stderr)
        return 2

    editor = SceneEditor(scene)
    mgr = ComponentManager()
    viewer = ScreenViewer(get_server().screen, port=args.serve or 0,
                          state_fn=lambda: mgr.state.name,
                          routes=editor.routes).start()
    print(f"editor: {viewer.url} (Ctrl-C to exit)", file=sys.stderr)
    try:
        while True:
            editor.mark_rendering(True)
            # trace a snapshot, not the live scene: POST /scene mutates it
            # concurrently and a torn mid-render scene is a wrong frame
            snapshot, version = editor.snapshot()
            t0 = time.perf_counter()
            # instant geometry preview first (ScreenView PREVIEW analogue):
            # the browser sees framing/placement while the real render runs
            try:
                from .renderers.preview import GeometryPreviewRenderer
                pv = GeometryPreviewRenderer().render(snapshot)
                get_server().screen.set(
                    np.clip(np.asarray(pv.pixels, np.float32), 0.0, 1.0),
                    pv.width, pv.height)
                print(f"preview v{version} in "
                      f"{time.perf_counter() - t0:.2f}s", file=sys.stderr)
            except Exception as exc:
                print(f"preview failed: {exc!r}", file=sys.stderr)
            result = None
            try:
                mgr.exec(args.renderer, snapshot)
                result = mgr.wait()
            except Exception as exc:
                # keep the editor alive: a crashing render (bad size, out
                # of device memory) must not lose the in-memory edits
                result = None
                print(f"render failed: {exc!r} (edit + apply to retry)",
                      file=sys.stderr)
            editor.mark_rendering(False)
            if result is not None:
                img = np.clip(np.asarray(result.pixels, np.float32),
                              0.0, 1.0)
                get_server().screen.set(img, img.shape[1], img.shape[0])
                if args.out:
                    write_png(args.out, result.pixels)
                print(f"rendered scene v{version} in "
                      f"{time.perf_counter() - t0:.2f}s", file=sys.stderr)
            # block until the next applied edit (short poll: Ctrl-C stays
            # responsive inside Event.wait on some platforms)
            while not editor.wait_dirty(timeout=0.5):
                pass
    except KeyboardInterrupt:
        pass
    viewer.stop()
    return 0


def _cmd_list(args) -> int:
    import nrenderer_tpu
    nrenderer_tpu._register_builtin_renderers()
    from .server.registry import get_server
    for info in get_server().component_factory.get_components_info("Render"):
        first = info.description.splitlines()[0] if info.description else ""
        print(f"{info.id:40s} {first}")
    return 0


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO, format="%(levelname)s %(message)s")
    import nrenderer_tpu
    nrenderer_tpu.enable_compilation_cache()
    p = argparse.ArgumentParser(prog="nrenderer_tpu")
    sub = p.add_subparsers(dest="cmd", required=True)

    def add_shared(p, spp_default=16):
        p.add_argument("--scene", help=".scn scene file")
        p.add_argument("--obj", action="append", default=[],
                       help="OBJ mesh file (repeatable)")
        p.add_argument("--renderer", default="SimplePathTracer")
        p.add_argument("--width", type=int, default=500)
        p.add_argument("--height", type=int, default=500)
        p.add_argument("--depth", type=int, default=20)
        p.add_argument("--spp", type=int, default=spp_default)
        p.add_argument("--out", default="out.png")
        p.add_argument("--camera-position", nargs=3, type=float)
        p.add_argument("--camera-look-at", nargs=3, type=float)
        p.add_argument("--fov", type=float)
        p.add_argument("--aperture", type=float)
        p.add_argument("--ambient", nargs=3, type=float,
                       help="constant ambient RGB")
        p.add_argument("--env-map", help="environment map image")
        p.add_argument("--roughness", type=float,
                       help="global microfacet roughness override "
                            "(reference RenderSettings global, now live)")
        p.add_argument("--f0", type=float,
                       help="global microfacet F0 override")
        p.add_argument("--metalness", type=float,
                       help="global microfacet metalness override")
        p.add_argument("--seed", type=int, default=0)

    pr = sub.add_parser("render", help="render a scene")
    add_shared(pr)
    pr.add_argument("--progressive", action="store_true",
                    help="render in passes with live Screen previews "
                         "(SimplePathTracer; AccPathTracer previews "
                         "automatically whenever the render is chunked)")
    pr.add_argument("--serve", type=int, nargs="?", const=0, default=None,
                    metavar="PORT",
                    help="serve a live browser view of the render "
                         "(progressive previews + final frame; PORT 0 or "
                         "omitted = auto-pick). Implies --progressive for "
                         "SimplePathTracer")
    pr.add_argument("--checkpoint",
                    help="checkpoint file for resumable rendering "
                         "(SimplePathTracer / AccPathTracer / "
                         "MetropolisLightTransport; composes with "
                         "--devices)")
    pr.add_argument("--devices", type=int, default=1,
                    help="shard over N devices: sample budget for "
                         "SimplePathTracer/AccPathTracer, Markov chains "
                         "for MetropolisLightTransport")
    pr.add_argument("--shard", choices=("samples", "pixels"),
                    default="samples",
                    help="multi-device decomposition: 'samples' (spp "
                         "sharded, one psum) or 'pixels' (disjoint film "
                         "bands, no collective; SimplePathTracer only)")
    pr.add_argument("--chains", type=int,
                    help="MLT: parallel Markov chains (default 1024)")
    pr.add_argument("--mutations", type=int,
                    help="MLT: mutations per chain (default 256)")
    pr.set_defaults(fn=_cmd_render)

    pe = sub.add_parser(
        "edit", help="interactive scene editor: serve an edit panel + "
                     "live view, re-rendering on every applied change "
                     "(the headless AssetView)")
    add_shared(pe)
    pe.add_argument("--serve", type=int, default=0, metavar="PORT",
                    help="editor HTTP port (0 = auto-pick)")
    pe.set_defaults(fn=_cmd_edit)

    pl = sub.add_parser("list-renderers", help="list registered renderers")
    pl.set_defaults(fn=_cmd_list)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
