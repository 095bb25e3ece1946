"""MoQ, mixture-of-quantization training (eigenvalue-scheduled precision),
PyTorch port of ``deepspeed_tpu/runtime/quantize.py``.

bits(l, t) = clip(start_bits - floor((t - offset) / period_l), target_bits,
start_bits), period_l = quantize_period times layer l's period scale: its
top Hessian eigenvalue over the mean of the layers' (1 until the first
probe), so a layer of larger curvature keeps its precision longer. The
bit widths are a host array; ``apply`` fake-quantizes each stacked layer
leaf ([L, ...], 3 or more dims) with one symmetric scale per layer at its
layer's bits, with the straight-through gradient, as JAX's vmapped
``_ste_quant_traced_bits``.

The probe (``layer_eigenvalues``) is JAX's: one power iteration over the
whole stacked-layer block, each layer's curvature read off the converged
(v, H·v) as the blockwise Rayleigh quotient |v_l · Hv_l| / (v_l · v_l).
H·v is ``runtime/eigenvalue``'s central difference of two gradient
passes, so each of its ``max_iter + 1`` products runs two forward and
backward passes through B1-B3.
"""

import logging
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from deepspeed_tpu_torch.ops.optimizers import tree_leaves, tree_map
from deepspeed_tpu_torch.parallel.partitioning import shard_sums
from deepspeed_tpu_torch.runtime.eigenvalue import (Eigenvalue,
                                                    hessian_vector_product,
                                                    random_direction)

logger = logging.getLogger("deepspeed_tpu_torch")


def ste_quant_layers(leaf, levels, amax_max=None):
    """Symmetric fake-quant of each layer of a stacked leaf [L, ...] with
    its own scale: ``levels`` [L] f32 (2^(bits - 1) - 1), JAX's f32 math,
    the straight-through gradient. ``amax_max``: on a mesh whose model
    axes cut the leaf's other dims, the max of the per-layer amax [L]
    over those ranks (the whole layer's scale)."""
    x32 = leaf.float()
    shape = (leaf.shape[0],) + (1,) * (leaf.dim() - 1)
    lv = levels.reshape(shape)
    amax = x32.detach().abs().reshape(leaf.shape[0], -1).amax(1)
    if amax_max is not None:
        amax = amax_max(amax)
    scale = torch.clamp_min(amax.reshape(shape) / lv, 1e-12)
    xq = torch.clamp(torch.round(x32.detach() / scale), -lv, lv)
    xq = (xq * scale).to(leaf.dtype)
    return leaf + (xq - leaf).detach()


def ste_quant_traced_bits(x, bits: float):
    """JAX's ``_ste_quant_traced_bits``: symmetric fake-quant of a whole
    leaf with one scale at ``bits`` (levels 2^(bits - 1) - 1 in f32), the
    straight-through gradient. The layer executor's MoQ, one layer's leaf
    at a time."""
    lv = np.power(np.float32(2.0), np.float32(bits) - np.float32(1.0)) \
        - np.float32(1.0)
    levels = torch.tensor([lv], dtype=torch.float32, device=x.device)
    return ste_quant_layers(x[None], levels)[0]


class MoQ:
    """The quantization-period scheduler and its param transform."""

    def __init__(self, config: Dict[str, Any], num_layers: int):
        bits_cfg = config.get("quantize_bits", {})
        sched = config.get("quantize_schedule", {})
        self.start_bits = int(bits_cfg.get("start_bits", 16))
        self.target_bits = int(bits_cfg.get("target_bits", 8))
        self.period = max(1, int(sched.get("quantize_period", 100)))
        self.offset = int(sched.get("schedule_offset", 0))
        ev = config.get("eigenvalue", {}) or {}
        self.ev_enabled = bool(ev.get("enabled", False))
        self.ev_cfg = ev
        self.num_layers = num_layers
        # period multiplier per layer; 1.0 until eigenvalues arrive
        self._period_scale = np.ones(num_layers, np.float64)
        self._ev_refresh_every = max(
            1, int(ev.get("gas_boundary_resolution", 1)) * self.period)
        self._last_ev_step = -1

    def bits(self, step: int) -> np.ndarray:
        """[L] f32 bit widths at global step ``step`` (host)."""
        t = max(0, step - self.offset)
        periods = np.maximum(1.0, self.period * self._period_scale)
        drop = np.floor(t / periods)
        b = np.clip(self.start_bits - drop, self.target_bits,
                    self.start_bits)
        return b.astype(np.float32)

    def wants_eigenvalues(self, step: int) -> bool:
        return (self.ev_enabled and step >= self.offset
                and (self._last_ev_step < 0
                     or step - self._last_ev_step >= self._ev_refresh_every))

    def update_eigenvalues(self, evs, step: int):
        """evs [L]: each layer block's top |eigenvalue|, normalized so the
        mean layer keeps the base period."""
        evs = np.maximum(np.asarray(evs, np.float64), 1e-12)
        self._period_scale = evs / evs.mean()
        self._last_ev_step = step
        logger.info(f"MoQ eigenvalues at step {step}: period scales "
                    f"{np.round(self._period_scale, 2).tolist()}")

    def apply(self, params, bits, split=None):
        """The params with each stacked layer leaf ([L, ...], 3 or more
        dims) fake-quantized at its layer's bits (``bits`` [L], host).
        ``split(path)``: the leaf's ``ModelSplit`` on a mesh (None: whole),
        whose per-layer amax is maxed over the ranks that cut the layer
        (MoQ never runs over ``pipe``, which would cut L)."""
        levels = None
        out = dict(params)
        layers = {}
        for k, v in params["layers"].items():
            sp = split("layers/" + k) if split is not None else None
            shape = sp.shape if sp is not None else tuple(v.shape)
            if len(shape) < 3 or shape[0] != self.num_layers:
                layers[k] = v
                continue
            if levels is None or levels.device != v.device:
                lv = np.power(np.float32(2.0), np.asarray(bits, np.float32)
                              - np.float32(1.0)) - np.float32(1.0)
                levels = torch.from_numpy(lv.astype(np.float32)).to(v.device)
            layers[k] = ste_quant_layers(
                v, levels, None if sp is None else sp.max)
        out["layers"] = layers
        return out

    def layer_eigenvalues(self, loss_fn: Callable, params, batch,
                          generator: Optional[torch.Generator] = None,
                          max_iter: Optional[int] = None, v=None,
                          reduce: Optional[Callable] = None,
                          splits: Optional[Dict[str, Any]] = None
                          ) -> np.ndarray:
        """Each layer's top |eigenvalue| (``loss_fn(params, batch)``, a
        scalar) by one power iteration over the stacked-layer block; ``v``:
        its start (default a normal draw from ``generator``, seed 0);
        ``reduce``: as ``hessian_vector_product``'s; ``splits``: on a mesh,
        {layer leaf name: its ``ModelSplit`` or None} (every norm and dot
        the whole leaves', the draw the one-rank draw sliced)."""
        ev = Eigenvalue(
            max_iterations=max_iter or int(self.ev_cfg.get("max_iter", 20)),
            tol=float(self.ev_cfg.get("tol", 1e-2)),
            stability=float(self.ev_cfg.get("stability", 1e-6)))
        sp = (None if splits is None else
              [splits.get(k) for k in sorted(params["layers"])])

        def block_loss(layer_stack):
            p = dict(params)
            p["layers"] = layer_stack
            return loss_fn(p, batch)

        def hvp(vv):
            return hessian_vector_product(block_loss, params["layers"], vv,
                                          reduce=reduce, splits=sp)

        def normalize(t):
            sums = [x.float().square().sum() for x in tree_leaves(t)]
            if sp is not None:
                sums = shard_sums(sums, sp)
            n = (torch.stack(sums).sum() + ev.stability).sqrt()
            return tree_map(lambda x: (x.float() / n).to(x.dtype), t)

        if v is None:
            device = tree_leaves(params["layers"])[0].device
            generator = generator or torch.Generator(device).manual_seed(0)
            v = random_direction(params["layers"], generator, splits=sp)
        for _ in range(ev.max_iterations):
            v = normalize(hvp(normalize(v)))
        v = normalize(v)
        hv = hvp(v)
        nums, dens = [], []
        for x, y in zip(tree_leaves(v), tree_leaves(hv)):
            x64 = x.double().reshape(x.shape[0], -1)
            nums.append((x64 * y.double().reshape(y.shape[0], -1)).sum(1))
            dens.append((x64 * x64).sum(1))
        if sp is not None:
            nums, dens = shard_sums(nums, sp), shard_sums(dens, sp)
        num = den = 0
        for a, b in zip(nums, dens):
            num, den = num + a, den + b
        num, den = num.cpu().numpy(), den.cpu().numpy()
        return np.abs(num) / np.maximum(den, 1e-12)


def build_moq(config: Dict[str, Any], num_layers: int) -> Optional[MoQ]:
    if not config or not config.get("enabled", False):
        return None
    moq = MoQ(config, num_layers)
    logger.info(f"MoQ: {moq.start_bits}->{moq.target_bits} bits over "
                f"period {moq.period} (offset {moq.offset})"
                + (", eigenvalue-scheduled" if moq.ev_enabled else ""))
    return moq
