"""Inference on a ``data`` mesh against JAX's.

JAX's ``InferenceEngine`` shards a batch over ``data`` when the data
degree divides it (``deepspeed_tpu/inference/engine.py:290-303``) and
replicates it otherwise. The port's engine on a 2-rank gloo group
(``_torch_pp_workers.group_dp2``, the tiny llama at 4 layers, f32) gives
each data rank its rows and every rank the whole output: ``generate`` of
4 prompts (2 a rank) and of 3 (replicated) token-identical to JAX's
engine on a ``{"data": 2}`` mesh of 2 of the conftest's virtual devices,
``forward``'s logits within 1e-5, one all-gather of the output a split
call. ``init_serving`` keeps refusing a data axis: JAX's
``ServingEngine`` has no data-split path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import transformer as jt
from deepspeed_tpu.parallel import mesh as jax_mesh
from deepspeed_tpu_torch.parallel import Mesh, MeshPlan
from deepspeed_tpu_torch.parallel.launch import run_group

from tests import _torch_pp_workers as P
from tests import _torch_cpu  # noqa: F401  (torch threads under xdist)

N_NEW = 12


@pytest.fixture(scope="module")
def runs():
    jm = jt.make_model(jt.llama_config("tiny", dtype=jnp.float32, **P.DIMS))
    mesh = jax_mesh.build_mesh(jax_mesh.MeshPlan(data=2),
                               devices=jax.devices()[:2])
    je = deepspeed_tpu.init_inference(jm, config={"kv_cache_bits": 0},
                                      dtype=jnp.float32, mesh=mesh)
    params = jax.tree.map(np.asarray, jax.device_get(je.params))
    prompts = np.random.default_rng(3).integers(
        0, P.DIMS["vocab_size"], (4, 20)).astype(np.int64)
    ranks = run_group(P.group_dp2, 2, params, prompts, N_NEW, threads=1,
                      timeout_s=300)
    want = {"split": np.asarray(je.generate(prompts, max_new_tokens=N_NEW)),
            "odd": np.asarray(je.generate(prompts[:3],
                                          max_new_tokens=N_NEW)),
            "logits": np.asarray(je.forward(prompts))}
    return ranks, want


@pytest.mark.parametrize("what", ["split", "odd"])
def test_data_mesh_generate_matches_jax(runs, what):
    """Greedy streams of the rows split over data=2 (4 prompts) and of a
    batch data=2 does not divide (3 prompts, replicated), on every rank,
    token-identical to JAX's engine on a data=2 mesh."""
    ranks, want = runs
    for r in ranks:
        np.testing.assert_array_equal(r[what], want[what])


def test_data_mesh_forward_and_rows(runs):
    """``forward``'s logits (each rank its rows, gathered) within 1e-5 of
    JAX's; rank i holds rows [2i, 2i + 2); a split generate gathers its
    output once over data."""
    ranks, want = runs
    for i, r in enumerate(ranks):
        np.testing.assert_allclose(r["logits"], want["logits"], rtol=1e-5,
                                   atol=1e-5)
        assert r["rows"] == slice(2 * i, 2 * i + 2)
        assert r["gathers"] == {"data": {"calls": 1, "bytes": 2 * (
            20 + N_NEW) * 8}}


def test_serving_refuses_a_data_axis():
    """JAX's ServingEngine shards its pools over tensor only and keeps one
    host state of slots (``deepspeed_tpu/inference/serving.py:440-457``):
    ``ServingEngine`` (which ``init_serving`` builds) on a data or fsdp
    mesh raises, naming that place (here on meshes laid at one rank, no
    process group); replicas serve behind the router."""
    model = P.model()
    for plan in (MeshPlan(data=2), MeshPlan(fsdp=2, tensor=2)):
        with pytest.raises(NotImplementedError, match="serving.py:440-457"):
            deepspeed_tpu_torch.init_serving(model, mesh=Mesh(plan),
                                             device="cpu")
    with pytest.raises(ValueError, match="pipe=2"):
        deepspeed_tpu_torch.init_inference(model, mesh=MeshPlan(pipe=2),
                                           device="cpu")
