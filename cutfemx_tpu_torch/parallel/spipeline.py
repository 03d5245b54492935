"""Owner-computes sharded cut pipeline: classify -> cut -> quadrature ->
assemble -> solve with NO global element set.

The torch counterpart of ``cutfemx_tpu.parallel.spipeline`` (the
reference's per-rank locality: each rank classifies and cuts only its
local cells, element loops run over local entities, ghost accumulation
via scatters):

- cells partition into geometric slabs with one-cell ghost layers
  (halo.build_slab_partition);
- each slab classifies ITS OWN cells (+ ghost layer) against the level
  set, generates runtime quadrature for ITS OWN cut cells, and builds form
  instances over slab-local entity subsets;
- the element kernels (forms/compile.py) run on the device over the
  slabs' entity data stacked along the slab axis and padded to equal
  shapes: element matrices only ever exist as per-slab device tensors;
- assembly accumulation is a local scatter into the slab's
  [owned | ghostL | ghostR] layout plus the ghost->owner adds of
  halo._halo_sync (scatter_rev(add));
- the solve is the halo CG (psum dot products over owned entries).

Ownership rules (each element computed exactly once, by one slab):
- cell entities: owned by their slab;
- facet entities: owned by the slab of facet_cells[f, 0]; the other cell
  is at most one layer away, so all its dofs are slab-local.

The reference wraps its element kernels in a shard_map with replication
tracking off (``_shard_map_novma``) so that JAX's AD does not psum the
cotangents of the per-slab kernels across devices. That wrapper has no
counterpart: the port's kernels are plain batched functions of the stacked
slab data, and nothing couples one slab's derivatives to another's.
"""

from __future__ import annotations

import numpy as np
import torch

from .halo import (HaloOperator, _halo_cg, _halo_sync, _SlabScatter,
                   build_slab_partition)

__all__ = ["SlabContext", "ShardedCutProblem", "cut_poisson_builder",
           "activity_weights"]


def activity_weights(phi, w_out=0.2, w_in=1.0, w_cut=3.0):
    """Per-cell load weights for build_slab_partition: cut cells carry
    runtime volume + interface + ghost-penalty work, inside cells one
    standard element, outside cells none (they still cost dof storage,
    hence the small floor weight)."""
    from ..cut.classify import classify_entities
    from ..cut.selector import DOMAIN_INSIDE, DOMAIN_INTERSECTED
    mesh = phi.function_space.mesh
    cells = np.arange(mesh.num_cells, dtype=np.int32)
    d = classify_entities(phi, mesh.tdim, cells)
    w = np.full(mesh.num_cells, float(w_out))
    w[d == DOMAIN_INSIDE] = float(w_in)
    w[d == DOMAIN_INTERSECTED] = float(w_cut)
    return w


def cut_poisson_builder(V, phi, gamma=40.0, gp=0.1, order=None):
    """Slab builder for the flagship cut-Poisson problem (the sharded form
    of demo_poisson / bench.py: Nitsche BC on {phi=0} + ghost penalty on
    the cut band, manufactured sin-product solution).

    Returns ``builder(ctx) -> (a_expr, L_expr)`` for ShardedCutProblem.
    """
    from ..cut.api import (cut as cut_fn, ghost_penalty_facets,
                           locate_entities, runtime_quadrature)
    from ..forms.dsl import (CellDiameter, FacetNormal, SpatialCoordinate,
                             TestFunction, TrialFunction, avg, dot, grad,
                             inner, jump, pi, sin)
    from ..forms.measure import Measure
    from ..level_set import normal as ls_normal

    mesh = V.mesh
    qorder = order or 2 * V.degree
    tdim = mesh.tdim

    def builder(ctx):
        cd = cut_fn(phi, entities=ctx.layer_cells, entity_dim=tdim)
        inside = ctx.own_cells(locate_entities(cd, "phi<0"))
        cut_own = ctx.own_cells(locate_entities(cd, "phi=0"))
        gpf = ctx.own_facets(ghost_penalty_facets(cd, "phi<0"))
        # runtime rules restricted to slab-owned cut cells
        if cut_own.size:
            cd_own = cut_fn(phi, entities=cut_own, entity_dim=tdim)
            vol = runtime_quadrature(cd_own, "phi<0", qorder)
            srf = runtime_quadrature(cd_own, "phi=0", qorder)
            dxo = Measure("dx", domain=mesh, subdomain_data=[inside, vol])
            dxg = Measure("dx", domain=mesh, subdomain_data=srf)
        else:
            dxo = Measure("dx", domain=mesh, subdomain_data=inside)
            dxg = None
        u, v = TrialFunction(V), TestFunction(V)
        x = SpatialCoordinate(mesh)
        ng = ls_normal(phi)
        h = CellDiameter(mesh)
        if tdim == 2:
            ue = sin(pi * x[0]) * sin(pi * x[1])
            f = 2 * pi ** 2 * ue
        else:
            ue = sin(pi * x[0]) * sin(pi * x[1]) * sin(pi * x[2])
            f = 3 * pi ** 2 * ue
        a = inner(grad(u), grad(v)) * dxo
        L = f * v * dxo
        if dxg is not None:
            a += (-dot(grad(u), ng) * v - dot(grad(v), ng) * u
                  + gamma / h * u * v) * dxg
            L += (-dot(grad(v), ng) * ue + gamma / h * ue * v) * dxg
        if gpf.size:
            dSg = Measure("dS", domain=mesh, subdomain_data=gpf)
            nf = FacetNormal(mesh)
            a += gp * avg(h) * inner(jump(grad(u), nf),
                                     jump(grad(v), nf)) * dSg
        return a, L

    return builder


class SlabContext:
    """Slab-local entity sets handed to the user's form builder.

    The builder mirrors the serial pipeline but restricted to this slab:

        def builder(ctx):
            cd = cfx.cut(phi, entities=ctx.layer_cells,
                         entity_dim=mesh.tdim)
            inside = ctx.own_cells(cfx.locate_entities(cd, "phi<0"))
            ...
            gp = ctx.own_facets(cfx.ghost_penalty_facets(cd, "phi<0"))
            return a_expr, L_expr
    """

    def __init__(self, mesh, cell_part, p):
        self.mesh = mesh
        self.part_index = int(p)
        self._cell_part = cell_part
        self.cells = np.flatnonzero(cell_part == p).astype(np.int32)
        # one-cell ghost layer via facet adjacency
        fc = mesh.facet_cells
        interior = fc[:, 1] >= 0
        a, b = fc[interior, 0], fc[interior, 1]
        in_p = cell_part == p
        nb = np.concatenate([b[in_p[a]], a[in_p[b]]])
        self.layer_cells = np.unique(
            np.concatenate([self.cells, nb])).astype(np.int32)

    def own_cells(self, cells):
        """Filter a cell array down to the cells this slab owns."""
        cells = np.asarray(cells, dtype=np.int32)
        return cells[self._cell_part[cells] == self.part_index]

    def own_facets(self, facets):
        """Filter a facet array down to slab-owned facets (owner = slab of
        the facet's first adjacent cell)."""
        facets = np.asarray(facets, dtype=np.int32)
        first = self.mesh.facet_cells[facets, 0]
        return facets[self._cell_part[first] == self.part_index]


def _pad_rows(arr, E, pad_value=None):
    """Pad the leading axis of a numpy array or tensor to E (replicating
    row 0, or with pad_value; zeros when there is no row 0)."""
    n = arr.shape[0]
    if n == E:
        return arr
    tail = (E - n,) + tuple(arr.shape[1:])
    if isinstance(arr, torch.Tensor):
        fill = arr[:1].expand(tail) if n and pad_value is None else \
            arr.new_full(tail, 0 if pad_value is None else pad_value)
        return torch.cat([arr, fill])
    arr = np.asarray(arr)
    fill = np.broadcast_to(arr[:1], tail) if n and pad_value is None else \
        np.full(tail, 0 if pad_value is None else pad_value, arr.dtype)
    return np.concatenate([arr, fill], axis=0)


def _pad_axis(arr, axis, n, edge=False):
    """Pad one axis of a tensor to length n with zeros (or by repeating
    its last entry)."""
    m = arr.shape[axis]
    if m == n:
        return arr
    shape = list(arr.shape)
    shape[axis] = n - m
    fill = arr.narrow(axis, m - 1, 1).expand(shape) if edge else \
        arr.new_zeros(shape)
    return torch.cat([arr, fill], dim=axis)


class _GroupPlan:
    """Cross-slab uniform shapes for one instance origin."""

    def __init__(self, kernel, itype, E, Q):
        self.kernel = kernel
        self.itype = itype
        self.E = E          # padded element count (uniform across slabs)
        self.Q = Q          # padded quadrature count (runtime) or None


def _make_plan(insts):
    ref = next(i for i in insts if i is not None)
    E = max(i.rows_cells.shape[0] for i in insts if i is not None)
    Q = None
    if ref.runtime:
        Q = max(i.data["weights"].shape[1] for i in insts if i is not None)
    return _GroupPlan(ref.kernel, ref.itype, E, Q)


def _normalize_instance_data(inst, plan):
    """Pad one slab instance's data to the group's uniform shapes.
    Zero-weight padding keeps the padded entries exactly zero."""
    data = dict(inst.data)
    E = plan.E
    for key in ("coords", "h", "local_facet"):
        if key in data:
            data[key] = _pad_rows(data[key], E)
    data["mask"] = _pad_rows(data["mask"], E, pad_value=0.0)
    if plan.Q is not None:
        data["points"] = _pad_axis(_pad_rows(data["points"], E), 1, plan.Q,
                                   edge=True)
        data["weights"] = _pad_axis(_pad_rows(data["weights"], E), 1,
                                    plan.Q)
    data["coeffs"] = tuple(_pad_rows(c, E) for c in data.get("coeffs", ()))
    qfs = []
    for qf_spec, arr in zip(plan.kernel.qfields, data.get("qfields", ())):
        a = _pad_rows(arr, E)
        if plan.Q is not None:
            qaxis = 2 if getattr(qf_spec, "side_dependent", False) else 1
            a = _pad_axis(a, qaxis, plan.Q, edge=True)
        qfs.append(a)
    data["qfields"] = tuple(qfs)
    return data


def _zero_instance_data(donor_data):
    """A slab's (already normalized) data with mask = 0: the kernel
    multiplies weights by the mask, so every element matrix is exactly
    zero."""
    out = dict(donor_data)
    out["mask"] = torch.zeros_like(donor_data["mask"])
    return out


def _stack_data(datas, mesh):
    """Per-slab data dicts -> one dict of (P_local * E, ...) leaves, the
    slabs' entities one after the other (what a batched kernel takes)."""
    def flat(t):
        return t.reshape(-1, *t.shape[2:])
    out = {}
    for key, v in datas[0].items():
        if isinstance(v, tuple):
            out[key] = tuple(flat(mesh.put([d[key][i] for d in datas]))
                             for i in range(len(v)))
        else:
            out[key] = flat(mesh.put([d[key] for d in datas]))
    return out


def _group_data(insts, plan, mesh):
    """Stacked kernel data of one group over all slabs (absent slabs get
    zero-mask copies of a present slab's data)."""
    datas = [None if inst is None else _normalize_instance_data(inst, plan)
             for inst in insts]
    donor = next(d for d in datas if d is not None)
    datas = [_zero_instance_data(donor) if d is None else d for d in datas]
    return _stack_data(datas, mesh)


def _slab_kernel(kind, plan, data, dtype, block, nloc):
    """The group's element matrices (kind 'matrix') or vectors ('vector')
    for every local slab: (P_local, E, ...)."""
    run = plan.kernel.assemble_matrix if kind == "matrix" else \
        plan.kernel.assemble_vector
    out = run(data, dtype, block)
    return out.reshape(nloc, plan.E, *out.shape[1:])


class ShardedCutProblem:
    """Distributed cut problem assembled owner-computes over a slab mesh.

    Parameters
    ----------
    V : FunctionSpace — test == trial space (square operator).
    builder : callable(SlabContext) -> (a_expr, L_expr) — builds the
        bilinear and linear FormExpr over THIS SLAB's entity subsets.
        May return (None, None) for slabs with no active entities.
    device_mesh : the slab mesh (``make_device_mesh``).
    """

    def __init__(self, V, builder, device_mesh, axis="cells", dtype=None,
                 weights=None):
        from ..fem import CutForm

        self.V = V
        self.mesh_dev = device_mesh
        self.axis = axis
        nparts = device_mesh.shape[axis]
        nloc = len(device_mesh.local)
        self.part = build_slab_partition(V, nparts, weights=weights)
        part = self.part
        dev = device_mesh.device

        # -- per-slab form construction (slab-local entities only) -------
        a_groups: dict = {}
        L_groups: dict = {}
        a_form_by_slab = [None] * nparts
        L_form_by_slab = [None] * nparts
        self.element_counts = np.zeros(nparts, np.int64)
        for p in range(nparts):
            ctx = SlabContext(V.mesh, part.cell_part, p)
            if ctx.cells.size == 0:
                continue
            a_expr, L_expr = builder(ctx)
            if a_expr is not None:
                af = CutForm(a_expr, dtype=dtype, device=dev)
                a_form_by_slab[p] = af
                for inst in af.instances:
                    a_groups.setdefault(inst.origin,
                                        [None] * nparts)[p] = inst
                self.element_counts[p] = sum(int(i.n_valid)
                                             for i in af.instances)
            if L_expr is not None:
                Lf = CutForm(L_expr, dtype=dtype, device=dev)
                L_form_by_slab[p] = Lf
                for inst in Lf.instances:
                    L_groups.setdefault(inst.origin,
                                        [None] * nparts)[p] = inst
        some = next((f for f in a_form_by_slab if f is not None), None)
        if some is None:
            raise ValueError("no slab produced any integral instance")
        self.dtype = some.dtype
        if some.test_space is not some.trial_space:
            raise ValueError(
                "ShardedCutProblem requires test space == trial space")

        pad_slot = part.local_size - 1

        def group_rows(insts, form_by_slab, plan):
            """(P, E, nd) LOCAL slot rows (padding slot when absent)."""
            per_slab = [None] * nparts
            nd = None
            for p, inst in enumerate(insts):
                if inst is None:
                    continue
                r = np.asarray(form_by_slab[p]._entity_dofs(V, inst))
                loc = part.locals_of_globals(p, r)
                # padded elements (mask == 0) scatter zero matrices; send
                # them to the padding slot anyway
                loc[inst.n_valid:] = pad_slot
                per_slab[p] = _pad_rows(loc, plan.E, pad_value=pad_slot)
                nd = loc.shape[1]
            return [np.full((plan.E, nd), pad_slot, np.int64) if r is None
                    else r for r in per_slab]

        # -- element matrices computed on the device per slab --------------
        d_instances = []
        touched = np.zeros((nparts, part.local_size), bool)
        for origin in sorted(a_groups):
            insts = a_groups[origin]
            plan = _make_plan(insts)
            rows = group_rows(insts, a_form_by_slab, plan)
            A = _slab_kernel("matrix", plan,
                             _group_data(insts, plan, device_mesh),
                             self.dtype, some.block, nloc)
            d_instances.append((A, device_mesh.put(rows)))
            for p, inst in enumerate(insts):
                if inst is not None:
                    touched[p][rows[p][:inst.n_valid].ravel()] = True
        touched[:, pad_slot] = False

        self.op = HaloOperator.from_device(part, device_mesh, d_instances,
                                           None, axis=axis)
        # ghost->owner OR + owner->ghost refresh makes slabs agree on
        # activity contributed by neighbor-slab elements
        d_act = self._halo_sum(device_mesh.put(touched.astype(np.float32))) \
            > 0
        self.op.d_active = d_act & device_mesh.put(part.global_of_local >= 0)

        # -- rhs assembled per slab on device + halo accumulation -----------
        b_local = torch.zeros((nloc, part.local_size), dtype=self.dtype,
                              device=dev)
        for origin in sorted(L_groups):
            insts = L_groups[origin]
            plan = _make_plan(insts)
            rows = group_rows(insts, L_form_by_slab, plan)
            be = _slab_kernel("vector", plan,
                              _group_data(insts, plan, device_mesh),
                              self.dtype, (some.block[0], None), nloc)
            b_local = b_local + _SlabScatter(
                [np.stack([rows[p] for p in device_mesh.local])],
                part.local_size, dev)([be])
        b_local = self._halo_sum(b_local)
        # zero the padding slot (absorbed padded-element scatters)
        b_local[:, pad_slot] = 0.0
        self.b_local = torch.where(self.op.d_active, b_local, 0.0)

    # ------------------------------------------------------------------

    def _halo_sum(self, y):
        """Ghost->owner add + owner->ghost refresh on a (P, local) tensor."""
        return _halo_sync(self.op, y)

    def solve_cg(self, rtol=1e-8, maxiter=500):
        """Distributed CG on the owner-computes operator. Returns
        (x_global, iterations, true residual norm)."""
        x, it, res = _halo_cg(self.op, self.b_local, rtol, maxiter)
        return self.op.to_global(x), int(it), float(res)

    def b_global(self):
        return self.op.to_global(self.b_local)
