"""Conductor showcase: a grid of spheres with the 14 metals from
`conductors.scn`.

The stock `conductors.scn` defines ONLY materials (no models — the reference
UI adds spheres by hand).  This example builds the showcase scene
programmatically: a Cornell shell, an area light, and a 7x2 sphere grid, one
per metal, rendered with AccPathTracer's microfacet BSDF (material type 3,
matching the .scn's type annotations).

    python examples/conductors_grid.py [out.png]
"""
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np

import nrenderer_tpu
from nrenderer_tpu import (
    AreaLight, Light, LightType, Model, Node, NodeType, Plane, Scene, Sphere,
    load_scn,
)
from nrenderer_tpu.io.image import write_png
from nrenderer_tpu.resources import scene_path
from nrenderer_tpu.scene.model import Material, Property, PropertyType


def build_scene() -> Scene:
    scene = load_scn(scene_path("conductors.scn"))

    white = Material(name="WhiteWall")
    white.register_property(Property("diffuseColor", PropertyType.RGB,
                                     (0.725, 0.71, 0.68)))
    wall_mat = len(scene.materials)
    scene.materials.append(white)

    model = Model(name="Shell", translation=(0.0, 0.0, 1028.0))
    midx = len(scene.models)
    scene.models.append(model)

    def add_plane(normal, position, u, v):
        p = Plane(normal=normal, position=position, u=u, v=v,
                  material=wall_mat)
        node = Node(name="wall", type=NodeType.PLANE,
                    entity=len(scene.plane_buffer), model=midx)
        model.nodes.append(len(scene.nodes))
        scene.nodes.append(node)
        scene.plane_buffer.append(p)

    s = 278.0
    add_plane((1, 0, 0), (-s, s, s), (0, -2 * s, 0), (0, 0, -2 * s))
    add_plane((-1, 0, 0), (s, s, s), (0, -2 * s, 0), (0, 0, -2 * s))
    add_plane((0, -1, 0), (s, s, s), (-2 * s, 0, 0), (0, 0, -2 * s))
    add_plane((0, 1, 0), (s, -s, s), (-2 * s, 0, 0), (0, 0, -2 * s))
    add_plane((0, 0, -1), (s, s, s), (-2 * s, 0, 0), (0, -2 * s, 0))

    grid = Model(name="Grid", translation=(0.0, 0.0, 1100.0))
    gidx = len(scene.models)
    scene.models.append(grid)
    metals = [i for i, m in enumerate(scene.materials) if m.type == 3]
    cols = 7
    for k, mat in enumerate(metals):
        r, c = divmod(k, cols)
        sph = Sphere(position=(-180.0 + c * 60.0, 60.0 - r * 120.0, 0.0),
                     radius=28.0, material=mat)
        node = Node(name=f"metal{k}", type=NodeType.SPHERE,
                    entity=len(scene.sphere_buffer), model=gidx)
        grid.nodes.append(len(scene.nodes))
        scene.nodes.append(node)
        scene.sphere_buffer.append(sph)

    scene.lights.append(Light(name="Top", type=LightType.AREA, entity=0))
    scene.area_light_buffer.append(AreaLight(
        radiance=(40.0, 40.0, 40.0), position=(80.0, 276.0, 1180.0),
        u=(-160.0, 0.0, 0.0), v=(0.0, 0.0, -160.0)))

    scene.render_option.width = 512
    scene.render_option.height = 512
    scene.render_option.samples_per_pixel = 512
    scene.render_option.depth = 8
    return scene


def main() -> int:
    out = sys.argv[1] if len(sys.argv) > 1 else "conductors_grid.png"
    nrenderer_tpu._register_builtin_renderers()
    from nrenderer_tpu.server.manager import ComponentManager
    scene = build_scene()
    mgr = ComponentManager()
    mgr.exec("AccPathTracer", scene)
    result = mgr.wait()
    write_png(out, result.pixels)
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
