"""The dense product under sharding rules: ``matmul(x, w)``, x (..., K)
by a 2-D w (K, N), with explicit placements.

DTensor's own propagation picks among zero-cost strategies freely (it
shards rows over an idle mesh axis, which later views cannot follow), so
the port plans each product as the reference's GSPMD lays out its
einsums, mesh dim by mesh dim:

  x rows (a dim before K) sharded     w gathered      out rows sharded
  x replicated, w columns sharded     kept            out N sharded
  x replicated, w rows or replicated  w gathered      out replicated
  x K sharded, w columns sharded      x gathered      out N sharded
  x K sharded, w otherwise            w rows sliced   out partial sum

and runs the local product on each rank's shards through ``local_map``,
with the gradients' placements stated (a replicated operand of a split
product gets a partial-sum gradient).  Plain tensors (no rules, or a
mesh of one rank's placements) take the same 2-D product, so a run
without rules is unchanged.
"""
from __future__ import annotations

import torch


def mm_local(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., K) by w (K, N) -> (..., N) as one 2-D product (the fold
    that ``torch.matmul`` makes of x)."""
    return (x.reshape(-1, x.shape[-1]) @ w).view(x.shape[:-1] + w.shape[1:])


def is_dtensor(*ts) -> bool:
    """Whether any of ``ts`` is a DTensor."""
    from torch.distributed.tensor import DTensor
    return any(isinstance(t, DTensor) for t in ts)


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., K) @ w (K, N): :func:`mm_local` on plain tensors, the
    planned product (module docstring) when either is a DTensor."""
    if not is_dtensor(x, w):
        return mm_local(x, w)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = (x if is_dtensor(x) else w).device_mesh
    rep = [Replicate()] * mesh.ndim
    if not is_dtensor(x):
        x = DTensor.from_local(x, mesh, rep, run_check=False)
    if not is_dtensor(w):
        w = DTensor.from_local(w, mesh, rep, run_check=False)
    last = x.dim() - 1
    R = Replicate()
    in_x, in_w, out, gx, gw = [], [], [], [], []
    for a, b in zip(x.placements, w.placements):
        a = a if type(a) is Shard else R      # partial / strided: gather
        b = b if type(b) is Shard else R
        if a != R and a.dim < last:                     # rows
            plan = (a, R, a, a, Partial())
        elif a != R:                                    # K over this dim
            plan = (R, b, Shard(last), Partial(), b) if b != R and \
                b.dim == 1 \
                else (a, Shard(0), Partial(), a, Shard(0))
        elif b != R and b.dim == 1:                     # columns
            plan = (R, b, Shard(last), Partial(), b)
        else:
            plan = (R, R, R, R, R)
        for lst, q in zip((in_x, in_w, out, gx, gw), plan):
            lst.append(q)
    return local_map(mm_local, out_placements=out,
                     in_placements=(in_x, in_w),
                     in_grad_placements=(gx, gw), device_mesh=mesh,
                     redistribute_inputs=True)(x, w)


def reshape_rows(x: torch.Tensor, shape) -> torch.Tensor:
    """``x.reshape(shape)`` where only the row-major order matters (the
    MoE's (B, S, D) <-> (G, g, D)).  A DTensor is reshaped shard by shard
    through ``local_map``: its dim-0 shards are kept where the new dim 0
    divides over them (each rank's rows stay its rows), every other
    placement is gathered first (DTensor's own view rules cannot follow
    a shard across such a reshape)."""
    if not is_dtensor(x):
        return x.reshape(shape)
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = x.device_mesh
    pl = [q if q == Shard(0) else Replicate() for q in x.placements]
    n = 1
    for j, q in enumerate(pl):
        n *= mesh.size(j) if q == Shard(0) else 1
    if shape[0] % n or x.shape[0] % n:
        pl, n = [Replicate()] * mesh.ndim, 1
    local = (shape[0] // n,) + tuple(shape[1:])
    return local_map(lambda t: t.reshape(local), out_placements=pl,
                     in_placements=(pl,), device_mesh=mesh,
                     redistribute_inputs=True)(x)


def unflatten(t: torch.Tensor, dim: int, sizes) -> torch.Tensor:
    """``t.unflatten(dim, sizes)``.  A DTensor whose ``dim`` is sharded
    over mesh dims that ``sizes[0]`` does not divide (heads split 16
    ways, viewed as 8 KV heads of 4) gathers that dim first: an uneven
    shard of the new outer dim has no view."""
    if is_dtensor(t):
        from torch.distributed.tensor import Replicate, Shard
        dim = dim % t.dim()
        mesh = t.device_mesh
        n, pl = 1, list(t.placements)
        for j, q in enumerate(pl):
            if isinstance(q, Shard) and q.dim == dim:
                n *= mesh.size(j)
        if sizes[0] % n:
            pl = [Replicate() if isinstance(q, Shard) and q.dim == dim
                  else q for q in pl]
            t = t.redistribute(mesh, pl)
    return t.unflatten(dim, sizes)


def flatten_last(t: torch.Tensor, n: int = 2) -> torch.Tensor:
    """``t.flatten(-n)``.  A DTensor's partial sums are reduced first, and
    it keeps at most one shard of the merged dims, the outermost dim's on
    one mesh dim; any other shard of them is gathered first (DTensor
    makes a strided shard of it, which it cannot redistribute under
    ``FakeTensorMode``)."""
    if is_dtensor(t):
        from torch.distributed.tensor import Replicate, Shard
        first = t.dim() - n
        pl, kept = [], False
        for q in t.placements:
            merged = isinstance(q, Shard) and q.dim >= first
            keep = merged and type(q) is Shard and q.dim == first \
                and not kept
            kept = kept or keep
            pl.append(Replicate() if (merged and not keep) or q.is_partial()
                      else q)
        if pl != list(t.placements):
            t = t.redistribute(t.device_mesh, pl)
    return t.flatten(-n)
