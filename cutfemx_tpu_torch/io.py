"""Mesh IO (the torch counterpart of ``cutfemx_tpu.io``): dependency-free
equivalents of the DOLFINx IO that upstream CutFEMx rides.

- ``write_vtu`` / ``write_cut_mesh``: VTU (XML unstructured grid) output
  readable by ParaView/VisIt; fields may be numpy arrays or tensors on any
  device (they are copied to the host);
- ``read_gmsh``: gmsh ``.msh`` ASCII reader (formats 2.2 and 4.1) with
  physical cell tags;
- ``write_xdmf`` / ``read_xdmf``: XDMF with inline-XML data items
  (round-trips meshes + vertex fields without HDF5);
- ``save_setup_cache`` / ``load_setup_cache``: the mesh topology and the
  dofmaps as raw ``.npy`` files, so a large host setup is built once.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .cut.quadrature import _host

__all__ = ["write_vtu", "write_cut_mesh", "read_gmsh", "write_xdmf",
           "read_xdmf", "MeshTags", "save_setup_cache", "load_setup_cache"]

_VTK_TYPE = {
    "interval": 3,       # VTK_LINE
    "triangle": 5,       # VTK_TRIANGLE
    "quadrilateral": 8,  # VTK_PIXEL ordering differs; use 9 with reorder
    "tetrahedron": 10,   # VTK_TETRA
    "hexahedron": 11,    # VTK_VOXEL ordering matches lexicographic
}


def _cells_for_vtk(mesh):
    cells = mesh.cells
    if mesh.cell_type == "quadrilateral":
        # lexicographic (v00,v10,v01,v11) -> VTK_QUAD (ccw)
        return cells[:, [0, 1, 3, 2]], 9
    return cells, _VTK_TYPE[mesh.cell_type]


def write_vtu(path, mesh, point_data=None, cell_data=None):
    """Write a mesh with optional per-vertex / per-cell scalar or vector
    fields. point_data/cell_data: {name: array} with leading length NV/NC;
    vector fields may be (N, gdim)."""
    cells, vtk_type = _cells_for_vtk(mesh)
    nv, nc = mesh.num_vertices, mesh.num_cells
    pts = np.zeros((nv, 3))
    pts[:, :mesh.gdim] = mesh.vertices

    def data_arrays(data, n):
        out = []
        for name, arr in (data or {}).items():
            a = _host(arr)
            if a.ndim == 1 and a.size == n * mesh.gdim and mesh.gdim > 1 \
                    and a.size != n:
                a = a.reshape(n, mesh.gdim)
            if a.ndim == 2 and a.shape[1] < 3:
                a = np.pad(a, ((0, 0), (0, 3 - a.shape[1])))
            ncomp = 1 if a.ndim == 1 else a.shape[1]
            out.append((name, ncomp, a.reshape(n, -1)))
        return out

    pdata = data_arrays(point_data, nv)
    cdata = data_arrays(cell_data, nc)

    def fmt(a):
        return " ".join(f"{v:.10g}" for v in np.asarray(a).ravel())

    with open(path, "w") as f:
        f.write('<?xml version="1.0"?>\n')
        f.write('<VTKFile type="UnstructuredGrid" version="0.1" '
                'byte_order="LittleEndian">\n<UnstructuredGrid>\n')
        f.write(f'<Piece NumberOfPoints="{nv}" NumberOfCells="{nc}">\n')
        f.write('<Points><DataArray type="Float64" NumberOfComponents="3"'
                ' format="ascii">\n')
        f.write(fmt(pts))
        f.write('\n</DataArray></Points>\n<Cells>\n')
        f.write('<DataArray type="Int64" Name="connectivity" '
                'format="ascii">\n')
        f.write(fmt(cells))
        f.write('\n</DataArray>\n<DataArray type="Int64" Name="offsets" '
                'format="ascii">\n')
        f.write(fmt(np.arange(1, nc + 1) * cells.shape[1]))
        f.write('\n</DataArray>\n<DataArray type="UInt8" Name="types" '
                'format="ascii">\n')
        f.write(fmt(np.full(nc, vtk_type)))
        f.write('\n</DataArray>\n</Cells>\n')
        for label, items in (("PointData", pdata), ("CellData", cdata)):
            f.write(f"<{label}>\n")
            for name, ncomp, a in items:
                f.write(f'<DataArray type="Float64" Name="{name}" '
                        f'NumberOfComponents="{ncomp}" format="ascii">\n')
                f.write(fmt(a))
                f.write("\n</DataArray>\n")
            f.write(f"</{label}>\n")
        f.write("</Piece>\n</UnstructuredGrid>\n</VTKFile>\n")


def write_cut_mesh(path, cut_mesh, functions=None):
    """Write a CutMesh with interpolated Functions (the role of upstream
    CutFEMx's cut-domain XDMF outputs): each Function is interpolated
    onto the visualisation mesh via fem.cut_function first when it lives
    on the background mesh."""
    from .fem import cut_function as _cut_function
    if cut_mesh.mesh is None:
        raise ValueError("empty cut mesh")
    point_data = {}
    for fn in (functions or []):
        if fn.function_space.mesh is cut_mesh.mesh:
            out = fn
        else:
            out = _cut_function(fn, cut_mesh)
        vals = _host(out.x)
        bs = out.function_space.bs
        nv = cut_mesh.mesh.num_vertices
        point_data[fn.name] = vals.reshape(nv, bs) if bs > 1 else \
            vals[:nv]
    cell_data = {"parent_index": cut_mesh.parent_index.astype(float),
                 "is_cut_cell": cut_mesh.is_cut_cell.astype(float)}
    write_vtu(path, cut_mesh.mesh, point_data=point_data,
              cell_data=cell_data)


# -- gmsh import ---------------------------------------------------------------

# gmsh element type -> (cell_type, nv, permutation gmsh -> package order)
_GMSH_TYPES = {
    1: ("interval", 2, [0, 1]),
    2: ("triangle", 3, [0, 1, 2]),
    3: ("quadrilateral", 4, [0, 1, 3, 2]),   # ccw -> lexicographic
    4: ("tetrahedron", 4, [0, 1, 2, 3]),
    5: ("hexahedron", 8, [0, 1, 3, 2, 4, 5, 7, 6]),
}

_DIM_OF_CELL = {"interval": 1, "triangle": 2, "quadrilateral": 2,
                "tetrahedron": 3, "hexahedron": 3}


@dataclass
class MeshTags:
    """Entity markers (the DOLFINx MeshTags role): parallel arrays of
    entity indices and integer tag values for entities of dim ``dim``."""
    dim: int
    indices: np.ndarray
    values: np.ndarray

    def find(self, value):
        return self.indices[self.values == int(value)]


def read_gmsh(path):
    """Read a gmsh ``.msh`` ASCII file (MshFileVersion 2.2 or 4.1).

    Returns ``(mesh, cell_tags, facet_tags)`` — the DOLFINx
    gmshio.read_from_msh contract. Cells of the highest topological
    dimension become the mesh; physical tags on those cells (and on
    codim-1 entities) become MeshTags (facet indices are resolved
    against the mesh's facet list; untagged -> empty tags)."""
    with open(path) as f:
        text = f.read()

    def section(name):
        start = text.find(f"${name}\n")
        if start < 0:
            return None
        start += len(name) + 2
        end = text.find(f"$End{name}", start)
        return text[start:end].strip("\n")

    fmt = section("MeshFormat").split()
    version = float(fmt[0])
    if int(fmt[1]) != 0:
        raise NotImplementedError("binary .msh files are not supported")

    if version >= 4.0:
        nodes_xyz, node_ids, blocks = _read_msh4(section)
    else:
        nodes_xyz, node_ids, blocks = _read_msh2(section)

    id_to_idx = {int(t): i for i, t in enumerate(node_ids)}

    # group by cell type
    by_type = {}
    for (etype, tag, conn) in blocks:
        if etype not in _GMSH_TYPES:
            continue
        ct, nv, perm = _GMSH_TYPES[etype]
        idx = np.vectorize(id_to_idx.__getitem__)(conn)[:, perm]
        by_type.setdefault(ct, []).append((tag, idx))

    if not by_type:
        raise ValueError("no supported elements in .msh file")
    tdim = max(_DIM_OF_CELL[ct] for ct in by_type)
    cell_types = [ct for ct in by_type if _DIM_OF_CELL[ct] == tdim]
    if len(cell_types) != 1:
        raise NotImplementedError(
            f"mixed cell types of dim {tdim}: {cell_types}")
    ct = cell_types[0]
    cells = np.concatenate([c for _, c in by_type[ct]])
    ctags = np.concatenate([np.full(len(c), t, np.int32)
                            for t, c in by_type[ct]])

    gdim = 3 if np.abs(nodes_xyz[:, 2]).max() > 0 else (
        2 if tdim >= 2 else tdim)
    gdim = max(gdim, tdim)
    from .mesh import Mesh
    mesh = Mesh(nodes_xyz[:, :gdim], cells.astype(np.int32), ct)
    cell_tags = MeshTags(tdim, np.arange(mesh.num_cells, dtype=np.int32),
                         ctags)

    # facet tags: match tagged codim-1 entities against mesh facets
    fct = [c for c in by_type if _DIM_OF_CELL[c] == tdim - 1]
    if fct:
        fverts = np.concatenate([c for _, c in by_type[fct[0]]])
        fvals = np.concatenate([np.full(len(c), t, np.int32)
                                for t, c in by_type[fct[0]]])
        key = np.sort(fverts, axis=1)
        mf = mesh.facets  # sorted rows
        # locate each tagged facet among mesh facets (lexicographic)
        order = np.lexsort(mf.T[::-1])
        mfs = mf[order]
        pos = np.zeros(len(key), np.int64)
        ok = np.ones(len(key), bool)
        for j, k in enumerate(key):
            lo = np.searchsorted(mfs[:, 0], k[0], side="left")
            hi = np.searchsorted(mfs[:, 0], k[0], side="right")
            hit = np.flatnonzero((mfs[lo:hi] == k).all(axis=1))
            if len(hit):
                pos[j] = order[lo + hit[0]]
            else:
                ok[j] = False
        facet_tags = MeshTags(tdim - 1, pos[ok].astype(np.int32),
                              fvals[ok])
    else:
        facet_tags = MeshTags(tdim - 1, np.zeros(0, np.int32),
                              np.zeros(0, np.int32))
    return mesh, cell_tags, facet_tags


def _read_msh2(section):
    lines = section("Nodes").splitlines()
    n = int(lines[0])
    dat = np.array([ln.split() for ln in lines[1:n + 1]], dtype=np.float64)
    node_ids = dat[:, 0].astype(np.int64)
    xyz = dat[:, 1:4]

    elines = section("Elements").splitlines()
    ne = int(elines[0])
    blocks = {}
    for ln in elines[1:ne + 1]:
        parts = [int(p) for p in ln.split()]
        etype, ntags = parts[1], parts[2]
        phys = parts[3] if ntags >= 1 else 0
        conn = parts[3 + ntags:]
        blocks.setdefault((etype, phys), []).append(conn)
    out = [(etype, phys, np.asarray(conns, np.int64))
           for (etype, phys), conns in blocks.items()]
    return xyz, node_ids, out


def _read_msh4(section):
    # physical tag per (dim, entityTag) from $Entities
    phys_of = {}
    ent = section("Entities")
    if ent is not None:
        lines = ent.splitlines()
        counts = [int(v) for v in lines[0].split()]
        k = 1
        for dim, cnt in enumerate(counts):
            for _ in range(cnt):
                parts = lines[k].split()
                k += 1
                tag = int(parts[0])
                nbox = 3 if dim == 0 else 6
                nphys = int(parts[1 + nbox])
                if nphys:
                    phys_of[(dim, tag)] = int(parts[2 + nbox])

    nlines = section("Nodes").splitlines()
    nblocks = int(nlines[0].split()[0])
    ids, coords = [], []
    k = 1
    for _ in range(nblocks):
        _, _, _, nn = (int(v) for v in nlines[k].split())
        k += 1
        ids.extend(int(nlines[k + i]) for i in range(nn))
        k += nn
        for i in range(nn):
            coords.append([float(v) for v in nlines[k + i].split()[:3]])
        k += nn
    xyz = np.asarray(coords, np.float64)
    node_ids = np.asarray(ids, np.int64)

    elines = section("Elements").splitlines()
    eblocks = int(elines[0].split()[0])
    out = []
    k = 1
    for _ in range(eblocks):
        dim, etag, etype, nn = (int(v) for v in elines[k].split())
        k += 1
        conn = np.array([[int(v) for v in elines[k + i].split()[1:]]
                         for i in range(nn)], np.int64)
        k += nn
        out.append((etype, phys_of.get((dim, etag), etag), conn))
    return xyz, node_ids, out


# -- XDMF (inline-XML data items) ---------------------------------------------

_XDMF_TOPO = {"interval": "Polyline", "triangle": "Triangle",
              "quadrilateral": "Quadrilateral",
              "tetrahedron": "Tetrahedron", "hexahedron": "Hexahedron"}
_TOPO_XDMF = {v: k for k, v in _XDMF_TOPO.items()}


def write_xdmf(path, mesh, point_data=None):
    """Write a mesh (+ per-vertex scalar/vector fields) as XDMF with
    inline data items (the XDMFFile role without HDF5)."""
    cells = mesh.cells
    if mesh.cell_type == "quadrilateral":
        cells = cells[:, [0, 1, 3, 2]]
    elif mesh.cell_type == "hexahedron":
        cells = cells[:, [0, 1, 3, 2, 4, 5, 7, 6]]
    nv = mesh.num_vertices
    pts = np.zeros((nv, 3))
    pts[:, :mesh.gdim] = mesh.vertices

    def fmt(a):
        return " ".join(f"{v:.12g}" for v in np.asarray(a).ravel())

    with open(path, "w") as f:
        f.write('<?xml version="1.0"?>\n<Xdmf Version="3.0">\n'
                '<Domain>\n<Grid Name="mesh" GridType="Uniform">\n')
        f.write(f'<Topology TopologyType="{_XDMF_TOPO[mesh.cell_type]}" '
                f'NumberOfElements="{mesh.num_cells}"')
        if mesh.cell_type == "interval":
            f.write(' NodesPerElement="2"')
        f.write('>\n<DataItem Dimensions='
                f'"{mesh.num_cells} {cells.shape[1]}" Format="XML">\n')
        f.write(fmt(cells))
        f.write('\n</DataItem>\n</Topology>\n')
        f.write('<Geometry GeometryType="XYZ">\n<DataItem '
                f'Dimensions="{nv} 3" Format="XML">\n')
        f.write(fmt(pts))
        f.write('\n</DataItem>\n</Geometry>\n')
        for name, arr in (point_data or {}).items():
            a = _host(arr)
            ncomp = 1 if a.ndim == 1 else a.shape[1]
            atype = "Scalar" if ncomp == 1 else "Vector"
            f.write(f'<Attribute Name="{name}" AttributeType="{atype}" '
                    'Center="Node">\n<DataItem Dimensions='
                    f'"{nv} {ncomp}" Format="XML">\n')
            f.write(fmt(a))
            f.write('\n</DataItem>\n</Attribute>\n')
        f.write('</Grid>\n</Domain>\n</Xdmf>\n')


def read_xdmf(path):
    """Read an inline-XML XDMF mesh written by write_xdmf (or compatible).
    Returns (mesh, point_data dict)."""
    import xml.etree.ElementTree as ET

    from .mesh import Mesh
    root = ET.parse(path).getroot()
    grid = root.find(".//Grid")
    topo = grid.find("Topology")
    ct = _TOPO_XDMF[topo.get("TopologyType")]
    conn = np.fromstring(topo.find("DataItem").text, sep=" ",
                         dtype=np.int64)
    nv_cell = {"interval": 2, "triangle": 3, "quadrilateral": 4,
               "tetrahedron": 4, "hexahedron": 8}[ct]
    cells = conn.reshape(-1, nv_cell)
    if ct == "quadrilateral":
        cells = cells[:, [0, 1, 3, 2]]
    elif ct == "hexahedron":
        cells = cells[:, [0, 1, 3, 2, 4, 5, 7, 6]]
    geo = grid.find("Geometry")
    pts = np.fromstring(geo.find("DataItem").text, sep=" ").reshape(-1, 3)
    # drop trailing zero dimensions beyond the topology's needs
    tdim = _DIM_OF_CELL[ct]
    gdim = 3 if np.abs(pts[:, 2]).max() > 0 else max(2, tdim) \
        if tdim >= 2 else tdim
    mesh = Mesh(pts[:, :gdim], cells.astype(np.int32), ct)
    point_data = {}
    for attr in grid.findall("Attribute"):
        dat = np.fromstring(attr.find("DataItem").text, sep=" ")
        dims = [int(v) for v in attr.find("DataItem").get(
            "Dimensions").split()]
        point_data[attr.get("Name")] = dat.reshape(dims) \
            if dims[-1] > 1 else dat
    return mesh, point_data


# ---------------------------------------------------------------------------
# Binary setup cache: mesh topology + function-space dofmaps
# ---------------------------------------------------------------------------
#
# The derived-topology build (unique edges and facets, adjacency, dofmaps)
# is deterministic, memory-bound host work that grows with the mesh, while
# reading the finished arrays back runs at disk speed. The cache holds what
# the runtime needs: the mesh, its derived topology computed so far, and
# each space's dofmap (no field values).

_SETUP_MESH_KEYS = ("edges", "cell_edges", "facets", "cell_facets",
                    "facet_cells", "facet_local_index", "hmax")


def save_setup_cache(path, mesh, spaces=()):
    """Persist ``mesh`` (+ derived topology already computed on it) and the
    dofmaps of ``spaces`` to directory ``path`` as raw ``.npy`` files.

    Only topology/dofmap arrays are stored — no field values. Spaces are
    restored in the same order by :func:`load_setup_cache`.
    """
    import json
    import os
    os.makedirs(path, exist_ok=True)

    def put(name, arr):
        np.save(os.path.join(path, name + ".npy"), np.ascontiguousarray(arr))

    meta = {"version": 1, "cell_type": mesh.cell_type,
            "lattice": None, "mesh_keys": [], "spaces": []}
    if mesh._lattice is not None:
        n_axes, order, kind = mesh._lattice
        meta["lattice"] = [list(int(v) for v in np.atleast_1d(n_axes)),
                           order, kind]
    put("vertices", mesh.vertices)
    put("cells", mesh.cells)
    for k in _SETUP_MESH_KEYS:
        if k in mesh._cache:
            meta["mesh_keys"].append(k)
            put("mesh_" + k, mesh._cache[k])
    for i, V in enumerate(spaces):
        meta["spaces"].append({
            "family": V.family, "degree": V.degree,
            "value_shape": list(V.value_shape),
            "num_scalar_dofs": int(V.num_scalar_dofs),
            "edge_off": int(getattr(V, "_edge_off", 0)),
            "face_off": int(getattr(V, "_face_off", 0)),
            "dof_coords": V._dof_coords is not None,
        })
        put(f"sp{i}_dofmap", V.dofmap)
        if V._dof_coords is not None:
            put(f"sp{i}_dof_coords", V._dof_coords)
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f)


def load_setup_cache(path, device=None):
    """Load a :func:`save_setup_cache` directory -> ``(mesh, [spaces])``.

    The spaces keep their data on ``device``: the CUDA card unless the
    caller asks for another (``device="cpu"``), as ``functionspace``.
    Returns ``None`` if ``path`` does not hold a valid cache (callers fall
    back to building from scratch).
    """
    import json
    import os
    from .elements import lagrange_element
    from .functionspace import FunctionSpace
    from .mesh import Mesh
    mf = os.path.join(path, "meta.json")
    if not os.path.exists(mf):
        return None
    try:
        with open(mf) as f:
            meta = json.load(f)
        if meta.get("version") != 1:
            return None

        def get(name):
            return np.load(os.path.join(path, name + ".npy"))

        mesh = Mesh(get("vertices"), get("cells"), meta["cell_type"])
        if meta["lattice"] is not None:
            n_axes, order, kind = meta["lattice"]
            mesh._lattice = (tuple(int(v) for v in n_axes), order, kind)
        for k in meta["mesh_keys"]:
            mesh._cache[k] = get("mesh_" + k)
        spaces = []
        for i, sp in enumerate(meta["spaces"]):
            # every field FunctionSpace.__init__ sets, the dofmap read
            # back instead of built
            V = FunctionSpace.__new__(FunctionSpace)
            V.device = torch.device("cuda" if device is None else device)
            V.mesh = mesh
            V.family = sp["family"]
            V.degree = int(sp["degree"])
            V.element = lagrange_element(mesh.cell_type, V.degree)
            V.value_shape = tuple(sp["value_shape"])
            V.bs = int(np.prod(V.value_shape)) if V.value_shape else 1
            V.dofmap = get(f"sp{i}_dofmap")
            V.num_scalar_dofs = sp["num_scalar_dofs"]
            V._edge_off = sp["edge_off"]
            V._face_off = sp["face_off"]
            V._dof_coords = (get(f"sp{i}_dof_coords")
                             if sp["dof_coords"] else None)
            spaces.append(V)
        return mesh, spaces
    except (OSError, ValueError, KeyError):
        return None
