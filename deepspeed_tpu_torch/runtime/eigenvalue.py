"""Hessian eigenvalue estimation by power iteration, PyTorch port of
``deepspeed_tpu/runtime/eigenvalue.py`` (it feeds MoQ's per-layer
quantization periods).

JAX takes H·v as ``jax.jvp(jax.grad(loss))``. The port's attention
backward (B2/B3 behind ``_FlashAttention.backward``) has no derivative of
its own, so a second derivative through the kernels does not exist on
the card. H·v is instead the central difference of two gradient passes,

    H·v ≈ (∇L(p + εv) − ∇L(p − εv)) / 2ε,

each pass an ordinary forward and backward through B1-B3 (and through the
same plain versions on the CPU), exact for a quadratic and O(ε²) off
otherwise. ε is one step for the whole direction, ε = ρ·‖p‖ / ‖v‖ over
the probed leaves: a different step per leaf would return H·diag(ε)·v,
which mixes the leaves' columns of H with different weights and is not
H·v. ρ is 2^-12 for f32 (or f64) leaves and 2^-6 for bf16 / f16 ones,
where a smaller step drowns in the rounding of p ± εv to the leaf's
dtype. ε stays a device scalar: a probe reads nothing back but the
Rayleigh quotients.

On a mesh whose model axes cut the probed leaves (``splits``: each
leaf's ``parallel.partitioning.ModelSplit``), a rank holds a slice of
each cut leaf and the whole of the others: every norm and dot adds the
slices' partial sums over the axes that cut each leaf
(``shard_sums``), so a leaf every rank holds whole counts once, and a
random direction is the one-rank draw of the whole leaf, sliced.
"""

import logging
from typing import Callable, Dict, Optional

import torch

from deepspeed_tpu_torch.ops.optimizers import tree_leaves, tree_map
from deepspeed_tpu_torch.parallel.partitioning import shard_sums

logger = logging.getLogger("deepspeed_tpu_torch")

RHO_F32 = 2.0 ** -12
RHO_LOW = 2.0 ** -6


def fd_rho(leaves) -> float:
    """ρ of the difference step for leaves of these dtypes."""
    wide = all(x.dtype in (torch.float32, torch.float64) for x in leaves)
    return RHO_F32 if wide else RHO_LOW


def _sq(leaves, splits=None):
    """The squared norm of ``leaves`` (on a mesh: of the whole leaves,
    ``splits`` in the leaves' order)."""
    sums = [x.detach().float().square().sum() for x in leaves]
    if splits is not None:
        sums = shard_sums(sums, splits)
    return torch.stack(sums).sum()


def hessian_vector_product(loss_fn: Callable, params, v,
                           reduce: Optional[Callable] = None,
                           splits=None):
    """H·v of ``loss_fn(params)`` (a scalar) at ``params`` (a dict tree of
    tensors) along ``v`` (the same tree), by the central difference of
    two gradient passes with ε = ρ·‖p‖ / ‖v‖ (ρ: ``fd_rho``).
    ``reduce(grads)``: applied to each pass's list of grads (the sum over
    the ranks that hold other rows or pieces of the batch). ``splits``:
    each leaf's ``ModelSplit`` or None, in ``tree_leaves`` order (the
    norms are the whole leaves'). Returns a tree like ``v``, in v's
    dtypes."""
    p_leaves, v_leaves = tree_leaves(params), tree_leaves(v)
    rho = fd_rho(p_leaves)
    pn, vn = _sq(p_leaves, splits).sqrt(), _sq(v_leaves, splits).sqrt()
    # a zero point (a freshly zeroed block) steps by rho itself
    eps = rho * torch.where(pn > 0, pn, torch.ones_like(pn)) / vn

    def grads_at(sign: float):
        moved = [(p.detach().float() + (sign * eps) * d.float())
                 .to(p.dtype).requires_grad_(True)
                 for p, d in zip(p_leaves, v_leaves)]
        it = iter(moved)
        loss = loss_fn(tree_map(lambda _: next(it), params))
        grads = torch.autograd.grad(loss, moved, materialize_grads=True)
        grads = [g.float() for g in grads]
        return reduce(grads) if reduce is not None else grads

    plus = grads_at(1.0)
    minus = grads_at(-1.0)
    it = iter([((a - b) / (2.0 * eps)).to(d.dtype)
               for a, b, d in zip(plus, minus, v_leaves)])
    return tree_map(lambda _: next(it), v)


def random_direction(tree, generator: torch.Generator, splits=None):
    """A standard normal tree like ``tree`` (drawn in f32 on each leaf's
    device, cast to its dtype), leaves in ``tree_leaves`` order.
    ``splits`` (each leaf's ``ModelSplit`` or None, in that order): a cut
    leaf is drawn whole and sliced, so each rank holds its slice of the
    one-rank draw."""
    it = iter(splits if splits is not None else [])

    def draw(x):
        sp = next(it, None)
        whole = torch.randn(x.shape if sp is None else sp.shape,
                            generator=generator, dtype=torch.float32,
                            device=x.device)
        return (whole if sp is None else sp.local(whole)).to(x.dtype)
    return tree_map(draw, tree)


class Eigenvalue:
    """Power iteration for the top |eigenvalue| of the loss Hessian; the
    constructor takes JAX's (and the reference's) arguments."""

    def __init__(self, verbose: bool = False, max_iterations: int = 100,
                 tol: float = 1e-2, stability: float = 1e-6,
                 gas_boundary_resolution: int = 1):
        self.verbose = verbose
        self.max_iterations = max_iterations
        self.tol = tol
        self.stability = stability
        self.gas_boundary_resolution = gas_boundary_resolution

    def compute_eigenvalue(self, loss_fn: Callable, params,
                           generator: Optional[torch.Generator] = None,
                           v=None) -> float:
        """Top |eigenvalue| of d2(loss)/dparams2; ``v``: the start (default
        a normal draw from ``generator``, seed 0)."""
        if v is None:
            device = tree_leaves(params)[0].device
            generator = generator or torch.Generator(device).manual_seed(0)
            v = random_direction(params, generator)
        ev = 0.0
        for i in range(self.max_iterations):
            vl = tree_leaves(v)
            n = _sq(vl).sqrt().to(vl[0].dtype)
            v = tree_map(lambda x: x / (n + self.stability), v)
            hv = hessian_vector_product(loss_fn, params, v)
            new_ev = float(sum((a.float() * b.float()).sum() for a, b in
                               zip(tree_leaves(v), tree_leaves(hv))))
            if self.verbose:
                logger.info(f"eigenvalue iter {i}: {new_ev:.6f}")
            if i > 0 and abs(new_ev - ev) <= self.tol * max(abs(new_ev),
                                                            1e-12):
                ev = new_ev
                break
            ev = new_ev
            v = hv
        return abs(ev)

    def compute_blockwise(self, loss_fn: Callable, params,
                          generator: Optional[torch.Generator] = None
                          ) -> Dict[str, float]:
        """The top |eigenvalue| of each top-level subtree's block."""
        out = {}
        for key in params:
            def block_loss(block, key=key):
                merged = dict(params)
                merged[key] = block
                return loss_fn(merged)
            out[str(key)] = self.compute_eigenvalue(block_loss, params[key],
                                                    generator)
        return out
