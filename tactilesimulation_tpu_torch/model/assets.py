"""Loaders for sidecar asset formats (host-side, numpy).

Formats (SURVEY.md §2.4):
- collision contact-point ``.txt``: first line = count, then one ``x y z`` per
  line (reference exemplar envs/assets/dclaw_rotate/contacts/one3_link.txt).
- abstract tactile spec ``.txt``: first line = count, then per marker five
  quoted vectors ``"pos" "image_pos" "normal" "axis0" "axis1"`` (written by
  reference envs/assets/dclaw_rotate/tactile/make_tactile.py:26-31).
"""

from __future__ import annotations

import re

import numpy as np


def load_contact_points(path: str) -> np.ndarray:
    with open(path) as f:
        lines = [ln.strip() for ln in f if ln.strip()]
    n = int(lines[0])
    pts = np.array([[float(x) for x in ln.split()] for ln in lines[1 : n + 1]])
    assert pts.shape == (n, 3), f"{path}: expected {n} xyz rows, got {pts.shape}"
    return pts


def load_tactile_spec(path: str):
    """Returns dict of numpy arrays: pos (M,3), image_pos (M,2) int,
    normal/axis0/axis1 (M,3)."""
    with open(path) as f:
        lines = [ln.strip() for ln in f if ln.strip()]
    n = int(lines[0])
    pos, image_pos, normal, axis0, axis1 = [], [], [], [], []
    for ln in lines[1 : n + 1]:
        fields = re.findall(r'"([^"]*)"', ln)
        assert len(fields) == 5, f"{path}: malformed marker line {ln!r}"
        vecs = [[float(x) for x in fld.split()] for fld in fields]
        pos.append(vecs[0])
        image_pos.append([int(float(x)) for x in fields[1].split()])
        normal.append(vecs[2])
        axis0.append(vecs[3])
        axis1.append(vecs[4])
    return {
        "pos": np.asarray(pos, dtype=np.float64),
        "image_pos": np.asarray(image_pos, dtype=np.int32),
        "normal": np.asarray(normal, dtype=np.float64),
        "axis0": np.asarray(axis0, dtype=np.float64),
        "axis1": np.asarray(axis1, dtype=np.float64),
    }


def load_obj_vertices_faces(path: str):
    """Minimal OBJ reader: returns (vertices (V,3) float64, faces (F,3) int or
    None). Polygon faces are fan-triangulated; v/vt/vn index forms accepted.
    Used by mesh collision bodies and the make_tactile generator (the
    reference shells out to trimesh, make_tactile.py:2)."""
    verts, faces = [], []
    with open(path) as f:
        for ln in f:
            if ln.startswith("v "):
                verts.append([float(x) for x in ln.split()[1:4]])
            elif ln.startswith("f "):
                idx = [int(tok.split("/")[0]) for tok in ln.split()[1:]]
                idx = [i - 1 if i > 0 else len(verts) + i for i in idx]
                for k in range(1, len(idx) - 1):
                    faces.append([idx[0], idx[k], idx[k + 1]])
    v = np.asarray(verts, dtype=np.float64)
    return v, (np.asarray(faces, dtype=np.int64) if faces else None)


def write_tactile_spec(path, pos, image_pos, normal, axis0, axis1):
    """Write the abstract tactile spec format (count line + quoted
    ``pos / image_pos / normal / axis0 / axis1`` records — the format
    load_tactile_spec reads and the reference generator writes,
    make_tactile.py:26-31)."""
    n = len(pos)
    with open(path, "w") as fp:
        fp.write(f"{n}\n")
        for i in range(n):
            p, ip = pos[i], image_pos[i]
            nm, a0, a1 = normal[i], axis0[i], axis1[i]
            fp.write(
                f'"{p[0]} {p[1]} {p[2]}" "{int(ip[0])} {int(ip[1])}" '
                f'"{nm[0]} {nm[1]} {nm[2]}" "{a0[0]} {a0[1]} {a0[2]}" '
                f'"{a1[0]} {a1[1]} {a1[2]}"\n')


def cuboid_surface_points(extents, resolution) -> np.ndarray:
    """Lattice over the cuboid surface: ``general_contact_resolution="nx ny nz"``
    (e.g. reference pusher.xml:44 box '2 2 2' -> the 8 corners)."""
    nx, ny, nz = (max(int(n), 2) for n in resolution)
    hx, hy, hz = np.asarray(extents, dtype=np.float64) / 2.0
    xs = np.linspace(-hx, hx, nx)
    ys = np.linspace(-hy, hy, ny)
    zs = np.linspace(-hz, hz, nz)
    gx, gy, gz = np.meshgrid(xs, ys, zs, indexing="ij")
    pts = np.stack([gx, gy, gz], axis=-1).reshape(-1, 3)
    on_surface = (
        (np.abs(np.abs(pts[:, 0]) - hx) < 1e-12)
        | (np.abs(np.abs(pts[:, 1]) - hy) < 1e-12)
        | (np.abs(np.abs(pts[:, 2]) - hz) < 1e-12)
    )
    return pts[on_surface]


def cylinder_face_points(radius, half_length, angle_res, radius_res) -> np.ndarray:
    """Points on both flat faces of a z-axis cylinder:
    ``general_contact_angle_resolution`` / ``_radius_resolution``
    (reference pusher.xml:30 tactile pads: 8 x 4)."""
    angle_res = max(int(angle_res), 3)
    radius_res = max(int(radius_res), 1)
    pts = []
    for z in (-half_length, half_length):
        pts.append([0.0, 0.0, z])
        for k in range(1, radius_res + 1):
            r = radius * k / radius_res
            for j in range(angle_res):
                a = 2.0 * np.pi * j / angle_res
                pts.append([r * np.cos(a), r * np.sin(a), z])
    return np.asarray(pts, dtype=np.float64)


def rect_array_markers(rect_pos0, rect_pos1, axis0, axis1, rows, cols):
    """Dense rectangular tactile grid (``type="rect_array"`` sensors,
    reference pusher.xml:61, tactile_pad.xml:29).

    Markers span ``rect_pos0 -> rect_pos1`` with rows along ``axis0`` and cols
    along ``axis1``; marker (r, c) maps to image position (r, c). The marker
    normal is ``axis0 x axis1`` (sign is immaterial to the physics — contact
    direction comes from the opposing primitive's SDF gradient — and the
    reference's depth visualization uses |normal force|).
    """
    p0 = np.asarray(rect_pos0, dtype=np.float64)
    p1 = np.asarray(rect_pos1, dtype=np.float64)
    a0 = np.asarray(axis0, dtype=np.float64)
    a1 = np.asarray(axis1, dtype=np.float64)
    a0 = a0 / np.linalg.norm(a0)
    a1 = a1 / np.linalg.norm(a1)
    d = p1 - p0
    span0 = float(d @ a0)
    span1 = float(d @ a1)
    fr = np.linspace(0.0, 1.0, rows) if rows > 1 else np.zeros(1)
    fc = np.linspace(0.0, 1.0, cols) if cols > 1 else np.zeros(1)
    pos = (
        p0[None, None, :]
        + fr[:, None, None] * span0 * a0[None, None, :]
        + fc[None, :, None] * span1 * a1[None, None, :]
    ).reshape(-1, 3)
    n = np.cross(a0, a1)
    m = rows * cols
    rr, cc = np.meshgrid(np.arange(rows), np.arange(cols), indexing="ij")
    image_pos = np.stack([rr, cc], axis=-1).reshape(-1, 2).astype(np.int32)
    return {
        "pos": pos,
        "image_pos": image_pos,
        "normal": np.tile(n, (m, 1)),
        "axis0": np.tile(a0, (m, 1)),
        "axis1": np.tile(a1, (m, 1)),
    }
