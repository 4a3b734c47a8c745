"""Offline abstract-tactile spec generator (the JAX package's
``examples/DClawExp/make_tactile.py``): select the mesh vertices above
``--min-y`` and write the per-marker spec file (``pos / image_pos / normal
/ axis0 / axis1`` quoted records) that ``<tactile type="abstract"
spec=...>`` scene declarations read. Numpy only.

    python -m tactilesimulation_tpu_torch.examples.make_tactile \
        mesh.obj out_tactile.txt [--min-y 0.07] [--image-offset 0.01] \
        [--image-scale 1000] [--flat-normal]

Per-marker normals are the mesh's area-weighted vertex normals with
tangent axes built per marker; ``--flat-normal`` writes +y normals and
+x/+z axes, as the reference tool does.
"""

import argparse

import numpy as np

from ..model.assets import load_obj_vertices_faces, write_tactile_spec


def tactile_spec(verts, faces, min_y=0.07, image_offset=0.01,
                 image_scale=1000.0, flat_normal=False):
    """(pos, image_pos, normal, axis0, axis1) of the vertices with
    y > ``min_y``."""
    sel = np.nonzero(verts[:, 1] > min_y)[0]
    if sel.size == 0:
        raise ValueError(f"no vertices with y > {min_y}")
    pos = verts[sel]
    # image coords: (x, z) shifted and scaled to integer pixel indices
    image_pos = ((pos[:, [0, 2]] + image_offset)
                 * image_scale).astype(np.int64)
    if flat_normal or faces is None:
        normal = np.tile([0.0, 1.0, 0.0], (sel.size, 1))
        axis0 = np.tile([1.0, 0.0, 0.0], (sel.size, 1))
        axis1 = np.tile([0.0, 0.0, 1.0], (sel.size, 1))
        return pos, image_pos, normal, axis0, axis1
    # area-weighted vertex normals over all faces
    vn = np.zeros_like(verts)
    tri = verts[faces]                                  # (F, 3, 3)
    fn = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    for k in range(3):
        np.add.at(vn, faces[:, k], fn)
    norms = np.linalg.norm(vn, axis=1, keepdims=True)
    vn = np.where(norms > 1e-12, vn / np.maximum(norms, 1e-12),
                  [0.0, 1.0, 0.0])
    normal = vn[sel]
    # tangent frame: axis0 = normalize(x - (x.n) n), else n x z
    ref = np.tile([1.0, 0.0, 0.0], (sel.size, 1))
    a0 = ref - np.sum(ref * normal, axis=1, keepdims=True) * normal
    bad = np.linalg.norm(a0, axis=1) < 1e-6
    a0[bad] = np.cross(normal[bad], [0.0, 0.0, 1.0])
    axis0 = a0 / np.linalg.norm(a0, axis=1, keepdims=True)
    return pos, image_pos, normal, axis0, np.cross(normal, axis0)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("obj", help="input OBJ mesh")
    ap.add_argument("out", help="output tactile spec .txt")
    ap.add_argument("--min-y", type=float, default=0.07,
                    help="select vertices with y > this")
    ap.add_argument("--image-offset", type=float, default=0.01)
    ap.add_argument("--image-scale", type=float, default=1000.0)
    ap.add_argument("--flat-normal", action="store_true",
                    help="normal +y, axes +x/+z, as the reference tool")
    args = ap.parse_args(argv)
    verts, faces = load_obj_vertices_faces(args.obj)
    try:
        spec = tactile_spec(verts, faces, args.min_y, args.image_offset,
                            args.image_scale, args.flat_normal)
    except ValueError as e:
        raise SystemExit(f"{e} in {args.obj}")
    write_tactile_spec(args.out, *spec)
    print(f"wrote {spec[0].shape[0]} markers -> {args.out}")


if __name__ == "__main__":
    main()
