"""Multi-slab sharding: distributed assembly + matrix-free solves.

The torch counterpart of ``cutfemx_tpu.parallel.operator``: the element
batch (cells) is split over the slabs of a 1D slab mesh; element matrices
apply slab-local, and the global scatter-add is one ``psum`` over the slabs
(the role of DOLFINx ``scatter_rev(add)``). Krylov vectors are replicated,
so CG's dot products need no collective: one psum per operator apply.

The slab mesh (``make_device_mesh``) stacks every slab on one device
(``comm.StackedComm``) or puts one slab in each process of a
``torch.distributed`` group (``comm.ProcessGroupComm``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..fem import segment_sum_sorted, sorted_scatter_plan
from .comm import ProcessGroupComm, SlabMesh, StackedComm

__all__ = ["make_device_mesh", "pad_to_multiple", "shard_instances",
           "sharded_matfree_operator", "sharded_cut_poisson_step"]


def make_device_mesh(n_devices=None, axis="cells", devices=None,
                     process_group=False):
    """A slab mesh of ``n_devices`` slabs (the reference's signature, plus
    ``process_group``).

    Without ``process_group``, every slab is stacked on ``devices[0]`` (the
    CUDA card by default) and ``n_devices`` defaults to ``len(devices)``:
    ``make_device_mesh(8, devices=["cuda:0"])`` puts 8 slabs on one card.
    With ``process_group=True``, one slab in each process of the
    initialized default group, on ``devices[0]`` or, by default, card
    ``rank % device_count``."""
    if process_group:
        comm = ProcessGroupComm()
        if n_devices is not None and int(n_devices) != comm.nparts:
            raise ValueError(f"{n_devices} slabs over a group of "
                             f"{comm.nparts} processes")
        dev = torch.device(devices[0]) if devices is not None else \
            torch.device("cuda", comm.rank % torch.cuda.device_count())
        return SlabMesh(comm.nparts, axis, dev, comm)
    devices = ["cuda"] if devices is None else list(devices)
    if len({str(torch.device(d)) for d in devices}) != 1:
        raise ValueError(f"stacked slabs live on one device, got {devices}; "
                         "use process_group=True for one slab a process")
    dev = torch.device(devices[0])
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    n = int(n_devices) if n_devices else len(devices)
    return SlabMesh(n, axis, dev, StackedComm(n))


def pad_to_multiple(arr, multiple, axis=0):
    """Zero-pad along axis to a multiple (element batches must divide the
    slab count; zero rows scatter zeros into dof 0 — harmless)."""
    n = arr.shape[axis]
    rem = (-n) % multiple
    if rem == 0:
        return arr
    if isinstance(arr, np.ndarray):
        pad = [(0, 0)] * arr.ndim
        pad[axis] = (0, rem)
        return np.pad(arr, pad)
    shape = list(arr.shape)
    shape[axis] = rem
    return torch.cat([arr, arr.new_zeros(shape)], dim=axis)


def shard_instances(element_matrices, dofs, mesh, axis="cells"):
    """Split (E, nd, nd) element matrices and (E, nd) dof maps over the
    slabs, padding E to a multiple of the slab count: (P_local, E/P, ...)
    tensors on the mesh's device."""
    n = mesh.shape[axis]
    out_m, out_d = [], []
    for Ae, dd in zip(element_matrices, dofs):
        Ae = pad_to_multiple(torch.as_tensor(Ae), n)
        dd = pad_to_multiple(torch.as_tensor(np.asarray(dd, np.int64)), n)
        out_m.append(mesh.put(Ae.reshape(n, -1, *Ae.shape[1:])))
        out_d.append(mesh.put(dd.reshape(n, -1, *dd.shape[1:])))
    return out_m, out_d


def sharded_matfree_operator(element_matrices, dofs, dim, mesh,
                             axis="cells", active=None):
    """Matrix-free A@x with cells split over the slabs.

    element_matrices: list of (P_local, E_i, nd_i, nd_i); dofs: list of
    (P_local, E_i, nd_i) (from shard_instances). x is replicated; so is
    the result (one psum per apply). Each slab's scatter is a sorted
    segment sum (no atomics)."""
    comm = mesh.comm
    nloc = element_matrices[0].shape[0]
    dev = element_matrices[0].device
    off = torch.arange(nloc, device=dev) * dim
    flat_rows = torch.cat([(dd + off[:, None, None]).reshape(-1)
                           for dd in dofs])
    perm, lengths = sorted_scatter_plan(flat_rows.cpu().numpy(),
                                        nloc * dim, dev)

    def apply(x):
        xin = torch.where(active, x, 0.0) if active is not None else x
        parts = [torch.einsum("peij,pej->pei", Ae, xin[dd]).reshape(-1)
                 for Ae, dd in zip(element_matrices, dofs)]
        y = segment_sum_sorted(torch.cat(parts)[perm], lengths)
        y = comm.psum(y.reshape(nloc, dim))[0]
        if active is not None:
            y = torch.where(active, y, x)
        return y

    return apply


def sharded_cut_poisson_step(form, domain, mesh, axis="cells",
                             cg_iters=20):
    """A distributed step for a rank-2 cut form: split the element batches
    over the slabs and run ``cg_iters`` Jacobi-preconditioned CG
    iterations. Returns ``step(b) -> (x, residual norm)``.

    This is the multi-chip 'training step' of the reference's
    ``__graft_entry__.dryrun_multichip``."""
    from ..fem import CutOperator
    from ..la import cg

    op = CutOperator(form, domain)
    mats, dofs = shard_instances(op.element_matrices, op._rows_host, mesh,
                                 axis)
    active = op.active
    apply = sharded_matfree_operator(mats, dofs, op.dim, mesh, axis,
                                     active=active)
    d = op.diagonal()

    def step(b):
        b = op._vector(b)
        bb = torch.where(active, b, 0.0) if active is not None else b
        x, its, res = cg(apply, bb, M=lambda r: r / d, rtol=1e-12,
                         maxiter=cg_iters)
        return x, res

    return step
