"""Tactile visualization (reference utils/tactile_utils.py P19 semantics):
force-field arrow image + normal-force depth map from an (rows, cols, 3)
array. matplotlib-based (headless-safe Agg backend), returning float images
in [0, 1] like the reference's cv2 canvases.

Port of ``tactilesimulation_tpu/utils/tactile_viz.py``. matplotlib is
imported inside the function that draws, so importing this module needs
none (the GPU host may have no matplotlib).
"""

from __future__ import annotations

import numpy as np


def _pyplot():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def visualize_tactile_image(tactile_array, shear_scale=1.0,
                            normal_scale=1.0):
    """Arrow image of the shear field, colored by normal force magnitude.
    tactile_array: (rows, cols, 3) of [shear0, shear1, normal]."""
    plt = _pyplot()
    arr = np.asarray(tactile_array)
    rows, cols = arr.shape[:2]
    fig, ax = plt.subplots(figsize=(max(cols / 4, 2), max(rows / 4, 2)),
                           dpi=60)
    rr, cc = np.meshgrid(np.arange(rows), np.arange(cols), indexing="ij")
    depth = np.abs(arr[..., 2]) * normal_scale
    depth = depth / (depth.max() + 1e-9)
    ax.quiver(cc, rr, arr[..., 1] * shear_scale, arr[..., 0] * shear_scale,
              depth, cmap="coolwarm", angles="xy")
    ax.set_ylim(rows - 0.5, -0.5)
    ax.set_aspect("equal")
    ax.axis("off")
    fig.canvas.draw()
    img = np.asarray(fig.canvas.buffer_rgba())[..., :3] / 255.0
    plt.close(fig)
    return img


def visualize_depth_image(tactile_array, normal_scale=1.0):
    """Normal-force depth map, |f_n| per marker as a grayscale image."""
    arr = np.asarray(tactile_array)
    depth = np.abs(arr[..., 2]) * normal_scale
    depth = depth / (depth.max() + 1e-9)
    return np.repeat(depth[..., None], 3, axis=-1)


def tactile_flow_grid(tactile_frames, spacing=2):
    """Tile (T, S, rows, cols, >=2) shear frames into one array image for
    quick inspection (reference visualize_tactile grids)."""
    frames = np.asarray(tactile_frames)
    T, S, rows, cols = frames.shape[:4]
    canvas = np.zeros((S * (rows + spacing), T * (cols + spacing), 3))
    for t in range(T):
        for s in range(S):
            mag = np.linalg.norm(frames[t, s, ..., :2], axis=-1)
            mag = mag / (mag.max() + 1e-9)
            canvas[s * (rows + spacing):s * (rows + spacing) + rows,
                   t * (cols + spacing):t * (cols + spacing) + cols, 1] = mag
    return canvas


def save_png(path, img):
    """Write a float image in [0, 1] as an 8-bit PNG (the JAX CLI's
    ``Image.fromarray((img * 255).astype(np.uint8)).save``)."""
    _pyplot().imsave(path, (np.asarray(img) * 255).astype(np.uint8))
