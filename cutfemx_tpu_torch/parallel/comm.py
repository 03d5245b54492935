"""Slab meshes and the three collectives of the distributed layer.

cutfemx_tpu writes its distributed code as per-shard bodies inside
``jax.shard_map`` over a 1D device mesh: every sharded array has a leading
mesh axis of equal padded shards, and the bodies talk through
``ppermute`` (open-ended shifts, so the end slab receives zeros), ``psum``
and ``pmax``. Here the same bodies run on tensors whose first axis is the
slab axis, and a communicator supplies the collectives:

- ``StackedComm``: all P slabs on one device, stacked along axis 0 (the
  shard_map layout itself). ``ppermute`` is a shift with zero fill along
  axis 0 (not ``torch.roll``, which would wrap the last slab onto the
  first), ``psum`` and ``pmax`` reduce over axis 0 and broadcast back (as
  an expanded view: the reduced value is computed once).
- ``ProcessGroupComm``: one slab per process of the default
  ``torch.distributed`` group (gloo on the CPU, NCCL across cards); the
  slab axis has length 1, ``ppermute`` is isend/irecv pairs and the
  reductions are ``all_reduce``.

Each communicator counts its calls per kind (``counts``), as
``interior_stencil.launches`` counts the kernel's launches.
"""

from __future__ import annotations

import torch

__all__ = ["StackedComm", "ProcessGroupComm", "SlabMesh"]

_KINDS = ("ppermute", "psum", "pmax")


class _Counted:
    def __init__(self):
        self.counts = dict.fromkeys(_KINDS, 0)

    def reset_counts(self):
        self.counts = dict.fromkeys(_KINDS, 0)


class StackedComm(_Counted):
    """All ``nparts`` slabs on one device, slab axis first."""

    def __init__(self, nparts):
        super().__init__()
        self.nparts = int(nparts)
        self.local_slabs = range(self.nparts)

    def ppermute(self, x, pairs):
        """out[dst] = x[src] for each (src, dst) of an open-ended shift
        (every pair p -> p + k, k = +-1: the bodies' only permutations);
        zeros where no slab sends."""
        self.counts["ppermute"] += 1
        pairs = list(pairs)
        out = torch.zeros_like(x)
        if not pairs:
            return out
        k = pairs[0][1] - pairs[0][0]
        lo, hi = max(0, -k), self.nparts - max(0, k)
        if abs(k) != 1 or pairs != [(p, p + k) for p in range(lo, hi)]:
            raise ValueError(f"ppermute takes an open-ended shift by one "
                             f"slab, got {pairs}")
        out[lo + k:hi + k] = x[lo:hi]
        return out

    def psum(self, x):
        self.counts["psum"] += 1
        return x.sum(0, keepdim=True).expand_as(x)

    def pmax(self, x):
        self.counts["pmax"] += 1
        return x.amax(0, keepdim=True).expand_as(x)

    def all_gather(self, x):
        """Every slab's block (host conversions; not a body collective)."""
        return x


class ProcessGroupComm(_Counted):
    """One slab per process of the default ``torch.distributed`` group."""

    def __init__(self):
        import torch.distributed as dist
        if not dist.is_initialized():
            raise RuntimeError("ProcessGroupComm needs an initialized "
                               "torch.distributed process group")
        super().__init__()
        self._dist = dist
        self.nparts = dist.get_world_size()
        self.rank = dist.get_rank()
        self.local_slabs = range(self.rank, self.rank + 1)

    def ppermute(self, x, pairs):
        self.counts["ppermute"] += 1
        dist = self._dist
        out = torch.zeros_like(x)
        send = x.contiguous()
        reqs = []
        for s, d in pairs:
            if s == self.rank:
                reqs.append(dist.isend(send, d))
            if d == self.rank:
                reqs.append(dist.irecv(out, s))
        for r in reqs:
            r.wait()
        return out

    def psum(self, x):
        self.counts["psum"] += 1
        y = x.clone()
        self._dist.all_reduce(y, op=self._dist.ReduceOp.SUM)
        return y

    def pmax(self, x):
        self.counts["pmax"] += 1
        y = x.clone()
        self._dist.all_reduce(y, op=self._dist.ReduceOp.MAX)
        return y

    def all_gather(self, x):
        parts = [torch.empty_like(x) for _ in range(self.nparts)]
        self._dist.all_gather(parts, x.contiguous())
        return torch.cat(parts)


class SlabMesh:
    """A 1D mesh of ``nparts`` slabs along ``axis`` (the port's stand-in
    for a ``jax.sharding.Mesh``): ``shape[axis]`` is the slab count, the
    slabs this process holds live on ``device``, and ``comm`` carries
    their collectives."""

    def __init__(self, nparts, axis, device, comm):
        self.axis = axis
        self.shape = {axis: int(nparts)}
        self.device = device
        self.comm = comm
        self.local = comm.local_slabs

    def put(self, per_slab, dtype=None):
        """This process's slabs of a per-slab sequence (numpy or tensors
        of equal shapes), stacked on the mesh's device: (P_local, ...)."""
        return torch.stack([torch.as_tensor(per_slab[p], dtype=dtype,
                                            device=self.device)
                            for p in self.local])

    def gather(self, x):
        """All slabs of a sharded tensor, as a host numpy array."""
        return self.comm.all_gather(x).detach().cpu().numpy()
