"""Offline trajectory renderer: headless matplotlib frames, PNGs and GIFs.

Port of ``tactilesimulation_tpu/utils/renderer.py``: draw the primitive
bodies along a recorded q-trajectory, write numbered PNG frames or an
animated GIF (pillow), for ``Simulation.replay`` and ``GymEnv.render``.

    SimRenderer.replay(sim, record=True, record_path="out.gif")    # facade
    render_trajectory(struct, model, qs, path)                     # functional

``q`` is numpy; the Model's leaves are read through ``.detach().cpu()`` and
FK runs on the host in float64. matplotlib (Agg backend) is imported inside
the functions only, so nothing on the card's paths imports it.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from ..model.schema import (GEOM_ABSTRACT, GEOM_CUBOID, GEOM_CYLINDER,
                            GEOM_MESH, GEOM_SPHERE)


def _pyplot():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def _host_model(model):
    """The Model's leaves on the host in float64, off any graph."""
    return type(model)(**{f.name: getattr(model, f.name).detach().cpu()
                          .to(torch.float64)
                          for f in dataclasses.fields(model)})


def _draw_body(ax, gtype, size, p, R, color):
    if gtype == GEOM_CUBOID or gtype == GEOM_MESH or gtype == GEOM_ABSTRACT:
        h = np.asarray(size) / 2.0
        corners = np.array([[sx * h[0], sy * h[1], sz * h[2]]
                            for sx in (-1, 1) for sy in (-1, 1)
                            for sz in (-1, 1)])
        pts = corners @ R.T + p
        edges = [(0, 1), (0, 2), (1, 3), (2, 3), (4, 5), (4, 6), (5, 7),
                 (6, 7), (0, 4), (1, 5), (2, 6), (3, 7)]
        for a, b in edges:
            ax.plot(*zip(pts[a], pts[b]), color=color, lw=0.8)
    elif gtype == GEOM_CYLINDER:
        r, hl = size[0], size[1]
        th = np.linspace(0, 2 * np.pi, 17)
        for z in (-hl, hl):
            ring = np.stack([r * np.cos(th), r * np.sin(th),
                             np.full_like(th, z)], axis=-1) @ R.T + p
            ax.plot(ring[:, 0], ring[:, 1], ring[:, 2], color=color, lw=0.8)
    elif gtype == GEOM_SPHERE:
        r = size[0]
        th = np.linspace(0, 2 * np.pi, 17)
        for axes in ((0, 1), (0, 2), (1, 2)):
            ring = np.zeros((17, 3))
            ring[:, axes[0]] = r * np.cos(th)
            ring[:, axes[1]] = r * np.sin(th)
            ring = ring @ R.T + p
            ax.plot(ring[:, 0], ring[:, 1], ring[:, 2], color=color, lw=0.8)


def render_frame(struct, model, q, ax=None, lim=0.3, camera=None):
    """One frame of the bodies at ``q`` (numpy, (ndof,)); a new figure when
    ``ax`` is None (returned), else drawn into ``ax``. ``camera``: optional
    (camera_pos, camera_lookat), the 3D view direction and centre."""
    from ..sim import kinematics, spatial
    plt = _pyplot()
    own_fig = ax is None
    if own_fig:
        fig = plt.figure(figsize=(5, 5), dpi=80)
        ax = fig.add_subplot(projection="3d")
    host = _host_model(model)
    with torch.no_grad():
        p, quat = kinematics.fk_bodies(
            struct, host, torch.as_tensor(np.asarray(q, np.float64)))
        R = spatial.quat_to_mat(quat)
    p, R = p.numpy(), R.numpy()
    sizes = host.body_size.numpy()
    rgba = host.body_rgba.numpy()
    for b in range(struct.nbodies):
        _draw_body(ax, struct.body_gtype[b], sizes[b], p[b], R[b],
                   tuple(np.clip(rgba[b, :3], 0, 1)))
    center = np.zeros(3)
    if camera is not None:
        pos = np.asarray(camera[0], float)
        lookat = np.asarray(camera[1], float)
        center = lookat
        d = pos - lookat
        ax.view_init(
            elev=float(np.degrees(np.arctan2(d[2], np.hypot(d[0], d[1])))),
            azim=float(np.degrees(np.arctan2(d[1], d[0]))))
    ax.set_xlim(center[0] - lim, center[0] + lim)
    ax.set_ylim(center[1] - lim, center[1] + lim)
    ax.set_zlim(center[2], center[2] + 2 * lim)
    return ax.figure if own_fig else None


def frame_pixels(fig) -> np.ndarray:
    """The figure's RGB pixels (H, W, 3) uint8; closes the figure."""
    fig.canvas.draw()
    px = np.asarray(fig.canvas.buffer_rgba())[..., :3].copy()
    _pyplot().close(fig)
    return px


def render_trajectory(struct, model, qs, path, fps=30, every=1, lim=0.3,
                      camera=None, speed=1.0, loop=False):
    """qs (T, ndof) -> numbered PNGs (``path`` a folder) or an animated GIF
    (``path`` ends with .gif); returns the frame count. ``speed`` scales
    the playback rate and ``loop`` makes the GIF repeat."""
    from PIL import Image
    qs = np.asarray(qs)[::every]
    frames = [frame_pixels(render_frame(struct, model, q, lim=lim,
                                        camera=camera)) for q in qs]
    if path.endswith(".gif"):
        imgs = [Image.fromarray(f) for f in frames]
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        # PIL GIF: loop=0 repeats forever; to play once the parameter must
        # be left out (loop=1 would play twice)
        kw = {"loop": 0} if loop else {}
        imgs[0].save(path, save_all=True, append_images=imgs[1:],
                     duration=int(1000 / (fps * max(speed, 1e-6))), **kw)
    else:
        os.makedirs(path, exist_ok=True)
        for i, f in enumerate(frames):
            Image.fromarray(f).save(os.path.join(path, f"{i}.png"))
    return len(frames)


class SimRenderer:
    """Facade replay: the recorded trajectory of a ``Simulation`` by its
    ``viewer_options``."""

    @staticmethod
    def replay(sim, record=False, record_path="replay.gif"):
        qs = sim.export_trajectory()
        vo = sim.viewer_options
        if record and len(qs):
            render_trajectory(sim.struct, sim.model, qs, record_path,
                              fps=vo.fps, speed=vo.speed, loop=vo.loop,
                              camera=(vo.camera_pos, vo.camera_lookat))
