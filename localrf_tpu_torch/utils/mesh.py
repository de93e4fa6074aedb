"""Isosurface extraction + PLY export (the port of localrf_tpu/utils/mesh.py;
an optional utility that no training path calls).

Counterpart of the reference's vestigial SDF->PLY export
(ref: utils/utils.py:319-379, never called in its training path):
marching tetrahedra (table-free, each cube split into 6 tets) and a PLY
written directly. `marching_tetrahedra` and `write_ply` are numpy, copied;
`export_density_ply` evaluates the field's alpha with the port's
`compute_dense_alpha` on the field's device.
"""
from __future__ import annotations

import numpy as np

# cube corner offsets (z, y, x) indexed 0..7
_CORNERS = np.array(
    [
        [0, 0, 0], [0, 0, 1], [0, 1, 0], [0, 1, 1],
        [1, 0, 0], [1, 0, 1], [1, 1, 0], [1, 1, 1],
    ]
)
# 6-tetrahedra decomposition of the cube
_TETS = np.array(
    [
        [0, 5, 1, 3], [0, 5, 3, 7], [0, 5, 7, 4],
        [0, 7, 3, 2], [0, 7, 2, 6], [0, 7, 6, 4],
    ]
)


def marching_tetrahedra(values: np.ndarray, level: float = 0.5):
    """Extract an isosurface from a dense [D, H, W] scalar field.

    Returns (vertices [N, 3] in (z, y, x) voxel coords, faces [M, 3]).
    """
    d, h, w = values.shape
    gz, gy, gx = np.meshgrid(
        np.arange(d - 1), np.arange(h - 1), np.arange(w - 1), indexing="ij"
    )
    base = np.stack([gz, gy, gx], -1).reshape(-1, 3)  # [C, 3] cube origins

    corner_pos = base[:, None, :] + _CORNERS[None]  # [C, 8, 3]
    corner_val = values[
        corner_pos[..., 0], corner_pos[..., 1], corner_pos[..., 2]
    ]  # [C, 8]

    verts_list, faces_list = [], []
    n_verts = 0
    for tet in _TETS:
        tv = corner_val[:, tet]  # [C, 4]
        tp = corner_pos[:, tet]  # [C, 4, 3]
        inside = tv > level  # [C, 4]
        count = inside.sum(axis=1)

        # case 1 or 3 inside -> one triangle; 2 inside -> quad (2 triangles)
        for n_in, flip in ((1, False), (3, True)):
            sel = count == n_in
            if not sel.any():
                continue
            v, p = tv[sel], tp[sel]
            ins = (v > level) if not flip else (v <= level)
            # the single "apex" vertex against the other three
            apex_idx = np.argmax(ins, axis=1)
            rows = np.arange(v.shape[0])
            others = np.array(
                [[j for j in range(4) if j != a] for a in apex_idx]
            )
            va = v[rows, apex_idx][:, None]
            pa = p[rows, apex_idx][:, None]
            vo = v[rows[:, None], others]
            po = p[rows[:, None], others]
            t = (level - va) / np.where(np.abs(vo - va) < 1e-12, 1e-12, vo - va)
            tri = pa + t[..., None] * (po - pa)  # [K, 3, 3]
            verts_list.append(tri.reshape(-1, 3))
            k = tri.shape[0]
            f = np.arange(k * 3).reshape(k, 3) + n_verts
            faces_list.append(f)
            n_verts += k * 3

        sel = count == 2
        if sel.any():
            v, p = tv[sel], tp[sel]
            ins = v > level
            # pair up the 2 inside with the 2 outside -> 4 edge crossings
            in_idx = np.argsort(~ins, axis=1)[:, :2]
            out_idx = np.argsort(ins, axis=1)[:, :2]
            rows = np.arange(v.shape[0])[:, None]
            quads = []
            for a, bcol in ((0, 0), (0, 1), (1, 1), (1, 0)):
                vi = v[rows[:, 0], in_idx[:, a]]
                vo_ = v[rows[:, 0], out_idx[:, bcol]]
                pi = p[rows[:, 0], in_idx[:, a]]
                po_ = p[rows[:, 0], out_idx[:, bcol]]
                t = (level - vi) / np.where(
                    np.abs(vo_ - vi) < 1e-12, 1e-12, vo_ - vi
                )
                quads.append(pi + t[:, None] * (po_ - pi))
            q = np.stack(quads, axis=1)  # [K, 4, 3] in ring order
            verts_list.append(q.reshape(-1, 3))
            k = q.shape[0]
            idx = np.arange(k * 4).reshape(k, 4) + n_verts
            faces_list.append(np.stack([idx[:, 0], idx[:, 1], idx[:, 2]], -1))
            faces_list.append(np.stack([idx[:, 0], idx[:, 2], idx[:, 3]], -1))
            n_verts += k * 4

    if not verts_list:
        return np.zeros((0, 3)), np.zeros((0, 3), np.int64)
    return np.concatenate(verts_list), np.concatenate(faces_list)


def write_ply(path: str, vertices: np.ndarray, faces: np.ndarray):
    """ASCII PLY writer (x, y, z vertices + triangular faces)."""
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(vertices)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write(f"element face {len(faces)}\n")
        f.write("property list uchar int vertex_indices\nend_header\n")
        for v in vertices:
            f.write(f"{v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for face in faces:
            f.write(f"3 {face[0]} {face[1]} {face[2]}\n")


def export_density_ply(params, cfg, path: str, grid_size=(128, 128, 128), level: float = 0.5):
    """Evaluate the field's alpha on a dense grid (on the device of
    `params`, a TensorfField) and export the isosurface in world
    coordinates (analog of the reference's convert_sdf_samples_to_ply).
    Returns the counts of vertices and faces."""
    import torch

    from ..models.tensorf import compute_dense_alpha

    with torch.no_grad():
        alpha = compute_dense_alpha(params, cfg, grid_size).cpu().numpy()
    # [gx, gy, gz] -> [z, y, x] for meshing, then map to world coords
    vol = alpha.transpose(2, 1, 0)
    verts, faces = marching_tetrahedra(vol, level)
    if len(verts):
        aabb = cfg.aabb
        sizes = np.array(grid_size, np.float32)
        # verts are (z, y, x); convert to world (x, y, z)
        rel = verts[:, ::-1] / np.maximum(sizes - 1, 1)
        world = aabb[0] + rel * (aabb[1] - aabb[0])
    else:
        world = verts
    write_ply(path, world, faces)
    return len(verts), len(faces)
