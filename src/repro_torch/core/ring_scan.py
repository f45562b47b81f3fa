"""Cross-device associative scan: recurrent state computed *in transit*.

For linear recurrences h_t = a_t ⊙ h_{t−1} + b_t (RG-LRU, Mamba2's chunk
states) with the sequence sharded across devices, the boundary state each
device needs is a fold of every earlier device's chunk summary. Instead of
gathering all summaries to an endpoint (Scenario 1 thinking), the summary
*packets* travel the ring and are combined at every hop — the recurrence
itself is computed by the network, the purest form of the paper's idea.

``ring_exclusive_scan`` uses log₂(p) doubling hops (each hop combines, so
it is still in-transit compute — just a tree of switches rather than a
chain); ``sequence_parallel_linear_scan`` applies it to a sharded
recurrence. Tensors carry the mesh dims first (``repro_torch.mesh``), then
each device's local shape; a hop is one ``ppermute``, over the world dim of
a ``Mesh`` or between the processes of a ``ProcessMesh``.
"""
from __future__ import annotations

import torch

from repro_torch.mesh import Mesh


def _combine(left, right):
    """(A, S) summaries: apply 'left' then 'right' segment.
    h ↦ A_r·(A_l·h + S_l) + S_r."""
    a_l, s_l = left
    a_r, s_r = right
    return a_l * a_r, a_r * s_l + s_r


def _device_index(mesh: Mesh, axis_name: str, x: torch.Tensor) -> torch.Tensor:
    """Each device's index along ``axis_name``, shaped to broadcast over ``x``."""
    r = mesh.axis_index(axis_name)
    return r.view(mesh.block + (1,) * (x.ndim - mesh.ndim))


def ring_exclusive_scan(a_prod, s_sum, mesh: Mesh, axis_name: str):
    """Exclusive device-prefix fold of per-device (A, S) chunk summaries.

    Returns, on device r, the fold of summaries of devices 0..r−1
    (identity (1, 0) on device 0). log2(p) ppermute hops; requires
    power-of-two ring size.
    """
    p = mesh.axis_size(axis_name)
    if p & (p - 1):
        raise ValueError(f"ring_exclusive_scan needs power-of-two ring, got {p}")
    r = _device_index(mesh, axis_name, a_prod)
    # F(k) on device r = fold of devices [r-k, r-1] (identity where r-k < 0)
    ident = (torch.ones_like(a_prod), torch.zeros_like(s_sum))
    # F(1): the immediate left neighbour's summary
    k = 1
    perm = [(i, (i + 1) % p) for i in range(p)]
    fa = mesh.ppermute(a_prod, axis_name, perm)
    fs = mesh.ppermute(s_sum, axis_name, perm)
    valid = r >= 1
    F = (torch.where(valid, fa, ident[0]), torch.where(valid, fs, ident[1]))
    while k < p:
        # F(2k)_r = combine(F(k)_{r-k}, F(k)_r)
        perm_k = [(i, (i + k) % p) for i in range(p)]
        ga = mesh.ppermute(F[0], axis_name, perm_k)
        gs = mesh.ppermute(F[1], axis_name, perm_k)
        # the shifted fold covers [r-2k, r-k-1]; it exists iff r-k >= 1
        use = r - k >= 1
        left = (torch.where(use, ga, ident[0]), torch.where(use, gs, ident[1]))
        F = _combine(left, F)
        k *= 2
    return F


def inclusive_linear_scan(a: torch.Tensor, b: torch.Tensor, dim: int):
    """Inclusive scan of (a, b) under ``_combine`` along ``dim``: position t
    gets the fold of positions [0..t]. Hillis–Steele, log₂ n doubling steps
    of whole-tensor ops (the port's ``lax.associative_scan``). Each step
    updates positions k.. in place, or, while autograd records (a step's
    inputs are saved for the backward), into new tensors: the same numbers."""
    n = a.shape[dim]
    records = torch.is_grad_enabled() and (a.requires_grad or b.requires_grad)
    ha, hb = (a, b) if records else (a.clone(), b.clone())
    k = 1
    while k < n:
        a_l, b_l = ha.narrow(dim, 0, n - k), hb.narrow(dim, 0, n - k)
        a_r, b_r = ha.narrow(dim, k, n - k), hb.narrow(dim, k, n - k)
        new_a, new_b = _combine((a_l, b_l), (a_r, b_r))
        if records:
            ha = torch.cat([ha.narrow(dim, 0, k), new_a], dim)
            hb = torch.cat([hb.narrow(dim, 0, k), new_b], dim)
        else:
            a_r.copy_(new_a)
            b_r.copy_(new_b)
        k *= 2
    return ha, hb


def sequence_parallel_linear_scan(a, b, mesh: Mesh, axis_name: str):
    """h_t = a_t·h_{t−1} + b_t over a sequence sharded on ``axis_name``.

    a, b: the mesh dims, then each device's (s_local, ...) chunk (device r
    holds positions [r·s_local, (r+1)·s_local)). Returns the local h
    chunks, laid out as ``a``.
    """
    t = mesh.ndim  # the local sequence dim
    # local inclusive scan: (ha_t, hb_t) = fold of local positions [0..t]
    ha, hb = inclusive_linear_scan(a, b, t)
    # device summary = last element; exclusive device-prefix in transit
    _, h_in = ring_exclusive_scan(ha.select(t, -1), hb.select(t, -1), mesh, axis_name)
    # h_t = ha_t · h_in + hb_t  (apply each local fold to the boundary state)
    return hb + ha * h_in.unsqueeze(t)
