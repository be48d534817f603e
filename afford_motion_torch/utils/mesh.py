"""Minimal mesh toolkit (counterpart of ``afford_motion_tpu/utils/mesh.py``,
in place of the trimesh primitives of the reference's visualizers: point
cloud export, cylinder / box / sphere / axis creation, concatenation;
utils/visualize.py:230-409). Pure numpy and binary PLY writers, no geometry
package; the colour map is a table of its own, so that no plotting package
is needed either."""
from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np


class SimpleMesh:
    def __init__(self, vertices: np.ndarray, faces: np.ndarray,
                 vertex_colors: Optional[np.ndarray] = None):
        self.vertices = np.asarray(vertices, dtype=np.float32)
        self.faces = np.asarray(faces, dtype=np.int64)
        self.vertex_colors = (
            np.asarray(vertex_colors, dtype=np.uint8) if vertex_colors is not None else None
        )

    def apply_translation(self, t: np.ndarray) -> "SimpleMesh":
        self.vertices = self.vertices + np.asarray(t, dtype=np.float32)
        return self

    def apply_transform(self, mat: np.ndarray) -> "SimpleMesh":
        self.vertices = self.vertices @ mat[:3, :3].T.astype(np.float32) + mat[:3, 3].astype(np.float32)
        return self

    def export(self, path: str) -> None:
        export_mesh_ply(path, self.vertices, self.faces, self.vertex_colors)


def concatenate(meshes: Sequence[SimpleMesh]) -> SimpleMesh:
    """One mesh of all; where some carry vertex colours, the others' vertices
    are grey (200) in as many channels. (The JAX package fills 4 channels
    whatever the others carry, so a coloured skeleton beside an uncoloured
    scene mesh raises there.)"""
    verts, faces, colors = [], [], []
    offset = 0
    widths = [m.vertex_colors.shape[1] for m in meshes if m.vertex_colors is not None]
    for m in meshes:
        verts.append(m.vertices)
        faces.append(m.faces + offset)
        if widths:
            c = m.vertex_colors
            if c is None:
                c = np.full((len(m.vertices), widths[0]), 200, dtype=np.uint8)
            colors.append(c)
        offset += len(m.vertices)
    return SimpleMesh(
        np.concatenate(verts), np.concatenate(faces),
        np.concatenate(colors) if widths else None,
    )


# ------------------------------------------------------------------- export
def export_pointcloud_ply(path: str, xyz: np.ndarray, colors: Optional[np.ndarray] = None) -> None:
    """Binary little-endian PLY point cloud (trimesh.PointCloud.export
    equivalent)."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    xyz = np.asarray(xyz, dtype="<f4")
    n = len(xyz)
    with open(path, "wb") as f:
        header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}",
                  "property float x", "property float y", "property float z"]
        if colors is not None:
            header += ["property uchar red", "property uchar green", "property uchar blue"]
        header += ["end_header"]
        f.write(("\n".join(header) + "\n").encode())
        if colors is not None:
            colors = np.asarray(colors, dtype=np.uint8)[:, :3]
            rec = np.zeros(n, dtype=[("xyz", "<f4", 3), ("rgb", "u1", 3)])
            rec["xyz"] = xyz
            rec["rgb"] = colors
            f.write(rec.tobytes())
        else:
            f.write(xyz.tobytes())


def export_mesh_ply(path: str, vertices: np.ndarray, faces: np.ndarray,
                    vertex_colors: Optional[np.ndarray] = None) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    vertices = np.asarray(vertices, dtype="<f4")
    faces = np.asarray(faces, dtype="<i4")
    n, m = len(vertices), len(faces)
    with open(path, "wb") as f:
        header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}",
                  "property float x", "property float y", "property float z"]
        if vertex_colors is not None:
            header += ["property uchar red", "property uchar green", "property uchar blue"]
        header += [f"element face {m}", "property list uchar int vertex_indices", "end_header"]
        f.write(("\n".join(header) + "\n").encode())
        if vertex_colors is not None:
            c = np.asarray(vertex_colors, dtype=np.uint8)[:, :3]
            rec = np.zeros(n, dtype=[("xyz", "<f4", 3), ("rgb", "u1", 3)])
            rec["xyz"] = vertices
            rec["rgb"] = c
            f.write(rec.tobytes())
        else:
            f.write(vertices.tobytes())
        frec = np.zeros(m, dtype=[("n", "u1"), ("idx", "<i4", 3)])
        frec["n"] = 3
        frec["idx"] = faces
        f.write(frec.tobytes())


def load_mesh_ply(path: str) -> SimpleMesh:
    """Minimal PLY reader (ascii + binary LE) for scene meshes."""
    with open(path, "rb") as f:
        data = f.read()
    head_end = data.index(b"end_header\n") + len(b"end_header\n")
    header = data[:head_end].decode("ascii", errors="replace").splitlines()
    body = data[head_end:]

    fmt = "ascii"
    n_v = n_f = 0
    v_props: List[tuple] = []
    section = None
    for line in header:
        parts = line.split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            section = parts[1]
            if section == "vertex":
                n_v = int(parts[2])
            elif section == "face":
                n_f = int(parts[2])
        elif parts[0] == "property" and section == "vertex" and parts[1] != "list":
            v_props.append((parts[2], parts[1]))

    type_map = {"float": "<f4", "float32": "<f4", "double": "<f8",
                "uchar": "u1", "uint8": "u1", "int": "<i4", "uint": "<u4",
                "short": "<i2", "ushort": "<u2", "char": "i1"}
    if fmt.startswith("binary_little"):
        vdtype = np.dtype([(nme, type_map[t]) for nme, t in v_props])
        verts_rec = np.frombuffer(body, dtype=vdtype, count=n_v)
        offset = vdtype.itemsize * n_v
        vertices = np.stack([verts_rec["x"], verts_rec["y"], verts_rec["z"]], axis=-1).astype(np.float32)
        faces = np.zeros((n_f, 3), dtype=np.int64)
        pos = offset
        for i in range(n_f):
            cnt = body[pos]
            pos += 1
            idx = np.frombuffer(body, dtype="<i4", count=cnt, offset=pos)
            faces[i] = idx[:3]
            pos += 4 * cnt
        return SimpleMesh(vertices, faces)
    # ascii
    lines = body.decode().splitlines()
    vertices = np.array([[float(x) for x in lines[i].split()[:3]] for i in range(n_v)], dtype=np.float32)
    faces = np.array([[int(x) for x in lines[n_v + i].split()[1:4]] for i in range(n_f)], dtype=np.int64)
    return SimpleMesh(vertices, faces)


# ---------------------------------------------------------------- primitives
def cylinder_between(p0: np.ndarray, p1: np.ndarray, radius: float = 0.01,
                     sections: int = 8, color=None) -> SimpleMesh:
    """Capped cylinder from p0 to p1 (trimesh.creation.cylinder(segment=...))."""
    p0, p1 = np.asarray(p0, np.float64), np.asarray(p1, np.float64)
    axis = p1 - p0
    h = np.linalg.norm(axis)
    if h < 1e-9:
        axis, h = np.array([0, 0, 1.0]), 1e-6
    z = axis / h
    # build orthonormal frame
    a = np.array([1.0, 0, 0]) if abs(z[0]) < 0.9 else np.array([0, 1.0, 0])
    x = np.cross(z, a); x /= np.linalg.norm(x)
    y = np.cross(z, x)
    ang = np.linspace(0, 2 * np.pi, sections, endpoint=False)
    ring = np.outer(np.cos(ang), x) + np.outer(np.sin(ang), y)
    bottom = p0 + radius * ring
    top = p1 + radius * ring
    verts = np.concatenate([bottom, top, p0[None], p1[None]])
    faces = []
    for i in range(sections):
        j = (i + 1) % sections
        faces += [[i, j, sections + i], [j, sections + j, sections + i]]
        faces += [[2 * sections, j, i], [2 * sections + 1, sections + i, sections + j]]
    colors = None
    if color is not None:
        colors = np.tile(np.asarray(color, np.uint8)[None, :3], (len(verts), 1))
    return SimpleMesh(verts, np.asarray(faces), colors)


def box(extents=(0.02, 0.02, 0.02), center=(0, 0, 0)) -> SimpleMesh:
    e = np.asarray(extents) / 2.0
    c = np.asarray(center)
    corners = np.array([[x, y, z] for x in (-1, 1) for y in (-1, 1) for z in (-1, 1)])
    verts = corners * e + c
    faces = np.array([
        [0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5], [0, 4, 5], [0, 5, 1],
        [2, 3, 7], [2, 7, 6], [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3],
    ])
    return SimpleMesh(verts, faces)


def uv_sphere(radius: float = 0.02, center=(0, 0, 0), rings: int = 8, sectors: int = 8) -> SimpleMesh:
    phi = np.linspace(0, np.pi, rings)
    theta = np.linspace(0, 2 * np.pi, sectors, endpoint=False)
    verts = []
    for p in phi:
        for t in theta:
            verts.append([np.sin(p) * np.cos(t), np.sin(p) * np.sin(t), np.cos(p)])
    verts = np.asarray(verts) * radius + np.asarray(center)
    faces = []
    for i in range(rings - 1):
        for j in range(sectors):
            a = i * sectors + j
            b = i * sectors + (j + 1) % sectors
            c = (i + 1) * sectors + j
            d = (i + 1) * sectors + (j + 1) % sectors
            faces += [[a, b, c], [b, d, c]]
    return SimpleMesh(verts, np.asarray(faces))


def axis_marker(origin_size: float = 0.05) -> SimpleMesh:
    """RGB xyz axis marker (trimesh.creation.axis equivalent)."""
    o = np.zeros(3)
    parts = [
        cylinder_between(o, [4 * origin_size, 0, 0], origin_size / 4, color=[255, 0, 0]),
        cylinder_between(o, [0, 4 * origin_size, 0], origin_size / 4, color=[0, 255, 0]),
        cylinder_between(o, [0, 0, 4 * origin_size], origin_size / 4, color=[0, 0, 255]),
    ]
    return concatenate(parts)


# matplotlib's viridis sampled at its 256 entries, each channel scaled by 255
# and truncated to uint8 (what (cmap(v)[:, :3] * 255).astype(np.uint8) gives)
_VIRIDIS_HEX = (
    "44015444025544035745055845065a45085b46095c460b5e460c5f460e61470f62471163"
    "47126547146647156747166947186a48196b481a6c481c6e481d6f481e70482071482172"
    "482273482374472575472676472777472878472a79472b7a472c7b462d7c462f7c46307d"
    "46317e45327f45347f453580453681443781443982433a83433b83433c84423d84423e85"
    "4240854141864142864043874044873f45873f47883e48883e49893d4a893d4b893d4c89"
    "3c4d8a3c4e8a3b508a3b518a3a528b3a538b39548b39558b38568b38578c37588c37598c"
    "365a8c365b8c355c8c355d8c345e8d345f8d33608d33618d32628d32638d31648d31658d"
    "31668d30678d30688d2f698d2f6a8d2e6b8e2e6c8e2e6d8e2d6e8e2d6f8e2c708e2c718e"
    "2c728e2b738e2b748e2a758e2a768e2a778e29788e29798e287a8e287a8e287b8e277c8e"
    "277d8e277e8e267f8e26808e26818e25828e25838d24848d24858d24868d23878d23888d"
    "23898d22898d228a8d228b8d218c8d218d8c218e8c208f8c20908c20918c1f928c1f938b"
    "1f948b1f958b1f968b1e978a1e988a1e998a1e998a1e9a891e9b891e9c891e9d881e9e88"
    "1e9f881ea0871fa1871fa2861fa38620a48520a58521a68521a78422a78423a88323a982"
    "24aa8225ab8126ac8127ad8028ae7f29af7f2ab07e2bb17d2cb17d2eb27c2fb37b30b47a"
    "32b57a33b67935b77836b87738b97639b9763bba753dbb743ebc7340bd7242be7144be70"
    "45bf6f47c06e49c16d4bc26c4dc26b4fc36951c46853c56755c66657c66559c7645bc862"
    "5ec96160c96062ca5f64cb5d67cc5c69cc5b6bcd596dce5870ce5672cf5574d05477d052"
    "79d1517cd24f7ed24e81d34c83d34b86d44988d5478bd5468dd64490d64392d74195d73f"
    "97d83e9ad83c9dd93a9fd938a2da37a5da35a7db33aadb32addc30afdc2eb2dd2cb5dd2b"
    "b7dd29bade27bdde26bfdf24c2df22c5df21c7e01fcae01ecde01dcfe11cd2e11bd4e11a"
    "d7e219dae218dce218dfe318e1e318e4e318e7e419e9e419ece41aeee51bf1e51cf3e51e"
    "f6e61ff8e621fae622fde724"
)
VIRIDIS = np.frombuffer(bytes.fromhex(_VIRIDIS_HEX), dtype=np.uint8).reshape(256, 3)


def colormap_values(values: np.ndarray) -> np.ndarray:
    """(N,) in [0,1] -> (N, 3) uint8 viridis colours (the reference uses cv2
    COLORMAP_PARULA; viridis is the closest standard map, the JAX package's
    default and only use): entry floor(256 v) of the table, the last for
    v = 1, values clipped to [0, 1] first; NaN maps to black, as
    matplotlib's "bad" colour does."""
    v = np.clip(np.asarray(values), 0, 1)
    bad = np.isnan(v)
    idx = np.minimum((np.where(bad, 0, v) * 256).astype(np.int64), 255)
    out = VIRIDIS[idx]
    out[bad] = 0
    return out
