"""Mesh extraction: density grid -> isosurface -> coloured PLY.

Port of ``intrinsicnerf_tpu/geometry/mesh.py``: the fine network is
queried (zero view directions) on a ``grid_dim^3`` grid inside the
scene's PCA-oriented bounds, ``occ = 1 - exp(-relu(sigma) * voxel)``;
marching tetrahedra at ``level`` and the small-component filter run on
the host (``native.py``); each vertex is coloured by rendering a ray
along its negative normal (or by its semantic argmax) and the mesh is
written as a binary PLY, byte for byte as the JAX writer writes it.

The grid query goes through ``models/mlp.py:eval_points`` without
gradient, so on the card the 8x256 network runs kernel 1 once per chunk
of 131,072 points (128 launches at 256^3); the grid stays on the device
and reaches the host in one copy.
"""

from __future__ import annotations

import struct
import time
from typing import Optional, Tuple

import numpy as np
import torch

from intrinsicnerf_tpu_torch.native import filter_small_components, marching_cubes, mesh_backend

QUERY_CHUNK = 128 * 1024  # points per grid query: the JAX chunk
RENDER_CHUNK = 4096  # rays per chunk of the vertex-colour render


# ----------------------------------------------------------------- PLY IO


def write_ply(path: str, vertices: np.ndarray, faces: Optional[np.ndarray] = None,
              colors: Optional[np.ndarray] = None, normals: Optional[np.ndarray] = None):
    """Binary little-endian PLY: float xyz (and normals), uchar colours,
    faces as a uchar count and three int indices."""
    v = np.asarray(vertices, np.float32)
    n = len(v)
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
    header += [f"property float {c}" for c in "xyz"]
    fields = [(c, "<f4") for c in "xyz"]
    if normals is not None:
        header += [f"property float n{c}" for c in "xyz"]
        fields += [(f"n{c}", "<f4") for c in "xyz"]
    if colors is not None:
        header += [f"property uchar {c}" for c in ("red", "green", "blue")]
        fields += [(c, "u1") for c in ("red", "green", "blue")]
    if faces is not None:
        header += [f"element face {len(faces)}", "property list uchar int vertex_indices"]
    header.append("end_header")

    rec = np.empty(n, np.dtype(fields))  # packed: no padding between the fields
    for i, c in enumerate("xyz"):
        rec[c] = v[:, i]
    if normals is not None:
        nrm = np.asarray(normals, np.float32)
        for i, c in enumerate("xyz"):
            rec[f"n{c}"] = nrm[:, i]
    if colors is not None:
        c8 = np.asarray(colors, np.uint8)
        for i, c in enumerate(("red", "green", "blue")):
            rec[c] = c8[:, i]
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode())
        f.write(rec.tobytes())
        if faces is not None:
            fc = np.empty(len(faces), np.dtype([("n", "u1"), ("v", "<i4", (3,))]))
            fc["n"] = 3
            fc["v"] = np.asarray(faces, np.int32)
            f.write(fc.tobytes())


def read_ply(path: str) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """A PLY's (vertices [V, 3], faces [F, 3] or None), ASCII or binary
    little-endian; other vertex properties are skipped."""
    type_map = {
        "float": "<f4", "float32": "<f4", "double": "<f8", "float64": "<f8",
        "uchar": "<u1", "uint8": "<u1", "char": "<i1", "int8": "<i1",
        "short": "<i2", "ushort": "<u2", "int": "<i4", "int32": "<i4",
        "uint": "<u4", "uint32": "<u4",
    }
    with open(path, "rb") as f:
        header = []
        while True:
            line = f.readline().decode("ascii", "replace").strip()
            header.append(line)
            if line == "end_header":
                break
        fmt = next(ln.split()[1] for ln in header if ln.startswith("format"))
        n_vert = n_face = 0
        vert_props, cur = [], None
        for line in header:
            if line.startswith("element vertex"):
                n_vert, cur = int(line.split()[-1]), "vertex"
            elif line.startswith("element face"):
                n_face, cur = int(line.split()[-1]), "face"
            elif line.startswith("property") and cur == "vertex":
                parts = line.split()
                vert_props.append((parts[1], parts[2]))
        xyz_idx = [i for i, (_, name) in enumerate(vert_props) if name in "xyz"][:3]

        if fmt == "ascii":
            verts = np.empty((n_vert, 3), np.float32)
            for i in range(n_vert):
                vals = f.readline().split()
                verts[i] = [float(vals[j]) for j in xyz_idx]
            faces = None
            if n_face:
                faces = np.empty((n_face, 3), np.int64)
                for i in range(n_face):
                    faces[i] = [int(x) for x in f.readline().split()[1:4]]
            return verts, faces

        dtype = np.dtype([(f"p{i}", type_map[t]) for i, (t, _) in enumerate(vert_props)])
        raw = np.frombuffer(f.read(dtype.itemsize * n_vert), dtype=dtype)
        verts = np.stack([raw[f"p{j}"].astype(np.float32) for j in xyz_idx], axis=1)
        faces = None
        if n_face:
            rest = f.read()
            tri = np.dtype([("n", "u1"), ("v", "<i4", (3,))])
            if len(rest) == tri.itemsize * n_face:  # all triangles: read them at once
                rows = np.frombuffer(rest, dtype=tri)
                if (rows["n"] == 3).all():
                    return verts, rows["v"].astype(np.int64)
            faces = np.empty((n_face, 3), np.int64)
            pos = 0
            for i in range(n_face):
                cnt = rest[pos]
                faces[i] = struct.unpack_from(f"<{cnt}i", rest, pos + 1)[:3]
                pos += 1 + 4 * cnt
        return verts, faces


# ------------------------------------------------------------ geometry


def oriented_bounds(points: np.ndarray):
    """PCA oriented bounding box: (transform [4, 4] from box-centred
    coordinates to the world, extents [3])."""
    pts = np.asarray(points, np.float64)
    center = pts.mean(0)
    centered = pts - center
    cov = centered.T @ centered / len(pts)
    _, vecs = np.linalg.eigh(cov)
    rot = vecs[:, ::-1]  # the principal axis first
    if np.linalg.det(rot) < 0:
        rot[:, -1] *= -1
    local = centered @ rot
    lo, hi = local.min(0), local.max(0)
    extents = hi - lo
    transform = np.eye(4)
    transform[:3, :3] = rot
    transform[:3, 3] = center + rot @ ((lo + hi) / 2)
    return transform.astype(np.float32), extents.astype(np.float32)


def grid_within_bound(occ_range: Tuple[float, float], extents: np.ndarray,
                      transform: np.ndarray, grid_dim: int):
    """``grid_dim^3`` world-space query points inside the oriented box (a
    grid over ``occ_range`` scaled by ``extents / (range * 0.9)``, then
    rotated and moved); returns (points [D^3, 3], scale [3])."""
    t = np.linspace(occ_range[0], occ_range[1], grid_dim, dtype=np.float32)
    gx, gy, gz = np.meshgrid(t, t, t, indexing="ij")
    grid = np.stack([gx, gy, gz], axis=-1)
    scale = np.asarray(extents, np.float32) / ((occ_range[1] - occ_range[0]) * 0.9)
    grid = grid * scale
    grid = grid @ transform[:3, :3].T + transform[:3, 3]
    return grid.reshape(-1, 3), scale


def vertex_normals(vertices: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Area-weighted per-vertex normals."""
    v = np.asarray(vertices, np.float64)
    f = np.asarray(faces, np.int64)
    fn = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
    vn = np.zeros_like(v)
    for i in range(3):
        np.add.at(vn, f[:, i], fn)
    norm = np.linalg.norm(vn, axis=1, keepdims=True)
    return (vn / np.maximum(norm, 1e-12)).astype(np.float32)


# ----------------------------------------------------------- extraction


@torch.no_grad()
def query_density_grid(model, mcfg, query_pts, voxel_size: float, chunk: int = QUERY_CHUNK):
    """Occupancy ``1 - exp(-relu(sigma) * voxel_size)`` (fp32, from the
    network's sigma) and the semantic argmax at each query point, with
    zero view directions, in chunks of ``chunk`` points on the model's
    device; the points go up once and the results come back once.
    Returns numpy (occupancy [N], labels [N])."""
    from intrinsicnerf_tpu_torch.models.mlp import eval_points

    dev = next(model.parameters()).device
    pts = torch.as_tensor(np.asarray(query_pts, np.float32), device=dev)
    n = pts.shape[0]
    occ = torch.empty(n, dtype=torch.float32, device=dev)
    sem = torch.zeros(n, dtype=torch.int64, device=dev)
    for s in range(0, n, chunk):
        p = pts[s:s + chunk]
        raw = eval_points(model, mcfg, p[:, None, :], torch.zeros_like(p))
        occ[s:s + chunk] = 1.0 - torch.exp(-torch.relu(raw.sigma[:, 0].float()) * voxel_size)
        if raw.sem_logits is not None:
            sem[s:s + chunk] = torch.argmax(raw.sem_logits[:, 0], dim=-1)
    return occ.cpu().numpy(), sem.cpu().numpy()


def extract_colour_mesh(trainer, scene_points: Optional[np.ndarray] = None, grid_dim: int = 256,
                        level: float = 0.45, min_cluster_faces: int = 400, near_t: float = 1.0,
                        color_mode: str = "rgb", out_path: str = "mesh.ply",
                        timings: Optional[dict] = None):
    """The whole extraction on a trained ``Trainer``: ``scene_points``
    (e.g. the dataset's scene mesh) set the oriented bounds, by default a
    cube 2.5 times the test cameras' span; the vertices are coloured by
    rendering along their negative normals (``color_mode="rgb"``) or by
    the rendered semantic argmax (``"semantic"``).  Returns (vertices,
    triangles, colours); ``timings``, a dict, receives the seconds of
    each stage."""
    from intrinsicnerf_tpu_torch.render.pipeline import render_rays
    from intrinsicnerf_tpu_torch.utils.image import label_colormap

    cfg = trainer.cfg
    model_c, model_f = trainer.state.model_coarse, trainer.state.model_fine
    dev = next(model_c.parameters()).device
    times = timings if timings is not None else {}
    if scene_points is None:
        origins = trainer.bundle.rays_test[:, 0, 0:3].cpu().numpy()
        center = origins.mean(0)
        span = max(np.ptp(origins, axis=0).max(), 1.0) * 2.5
        scene_points = center + span / 2 * np.array(
            [[x, y, z] for x in (-1, 1) for y in (-1, 1) for z in (-1, 1)])
    transform, extents = oriented_bounds(scene_points)
    query_pts, _ = grid_within_bound([-1.0, 1.0], extents, transform, grid_dim)

    near, far = cfg.depth_range
    voxel_size = (far - near) / cfg.render.n_importance
    t0 = time.perf_counter()
    occ, _ = query_density_grid(model_f if model_f is not None else model_c, trainer.mcfg,
                                query_pts, voxel_size)
    times["query_s"] = time.perf_counter() - t0
    occ = occ.reshape(grid_dim, grid_dim, grid_dim)
    print(f"occupied fraction @{level}: {(occ > level).mean():.4f}")

    t0 = time.perf_counter()
    verts, tris = marching_cubes(occ, level)
    if len(tris) == 0:
        raise RuntimeError("empty isosurface: lower the level?")
    keep = filter_small_components(tris, len(verts), min_cluster_faces)
    tris = tris[keep]
    used = np.unique(tris)
    remap = np.full(len(verts), -1, np.int64)
    remap[used] = np.arange(len(used))
    verts, tris = verts[used], remap[tris]
    times["march_s"] = time.perf_counter() - t0
    times["mesh_backend"] = mesh_backend()

    # grid coordinates -> [-1, 1] -> the oriented box -> the world
    verts_w = verts / (grid_dim - 1) * 2.0 - 1.0
    verts_w = verts_w * (extents / 2.0)
    verts_w = verts_w @ transform[:3, :3].T + transform[:3, 3]
    normals = vertex_normals(verts_w, tris)

    # colour by rendering along the negative vertex normal
    rays_d = -normals
    rays_o = verts_w - rays_d * (near * near_t)
    viewdirs = rays_d / np.linalg.norm(rays_d, axis=1, keepdims=True)
    nf = np.broadcast_to(np.asarray([near, far], np.float32), (len(verts_w), 2))
    rays = np.concatenate([rays_o, rays_d, nf, viewdirs], axis=1).astype(np.float32)
    t0 = time.perf_counter()
    semantic = color_mode == "semantic" and trainer.mcfg.enable_semantic
    parts = []
    with torch.no_grad():  # each chunk keeps only its colour or label
        for r in torch.split(torch.as_tensor(rays, device=dev), RENDER_CHUNK):
            out = render_rays(model_c, model_f, trainer.mcfg, r, cfg.render, train=False)
            maps = out.fine if out.fine is not None else out.coarse
            parts.append(torch.argmax(maps.sem_logits, -1) if semantic else maps.rgb.float())
    got = torch.cat(parts).cpu().numpy()
    if semantic:
        cmap = trainer.bundle.colour_map
        if cmap is None:
            cmap = label_colormap(trainer.bundle.num_valid_classes + 2)
        colors = np.asarray(cmap)[1:][got].astype(np.uint8)
    else:
        colors = (np.clip(got, 0, 1) * 255).astype(np.uint8)
    times["render_s"] = time.perf_counter() - t0
    times["render_rays"] = len(rays)

    t0 = time.perf_counter()
    write_ply(out_path, verts_w, tris, colors=colors, normals=normals)
    times["write_s"] = time.perf_counter() - t0
    print(f"wrote {out_path}: {len(verts_w)} vertices, {len(tris)} faces (marching: "
          f"{times['mesh_backend']}; query {times['query_s']:.3f} s, marching "
          f"{times['march_s']:.3f} s, colour render {times['render_s']:.3f} s)")
    return verts_w, tris, colors
