"""Offload over ranks (ROADMAP A8d): the layer executor on ``fsdp`` = 2,
``data`` = 2 at gas 2 and ``fsdp`` = 2 x ``tensor`` = 2, with a family
and the training extras, and the NVMe optimizer swapper at ``data`` = 2,
each against JAX's executor (or swapper) on the same mesh of the
conftest's virtual CPU devices and against the port at one rank; each
rank's share of the chunks; a checkpoint moving between fsdp degrees;
and the mesh axes that stay refused.

The ranks are gloo groups of 2 and 4 processes (rank programs in
``tests/_torch_infinity_mesh_workers.py``) started once for the module,
while this process runs JAX's engines. Both packages start from one
seeded tree (nonzero biases and norms; ``test_torch_infinity_compose``'s
helpers). Bars as at one rank: losses within 1e-5 (relative), masters
within 1e-6 relative L2.
"""

import concurrent.futures
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import transformer as jt
from deepspeed_tpu_torch.models import transformer as tt
from deepspeed_tpu_torch.parallel.launch import run_group

from tests import _torch_cpu  # noqa: F401  (torch threads under xdist)
from tests import _torch_infinity_mesh_workers as W
from tests.test_torch_infinity_compose import (rel_l2, seed_jax_executor,
                                               seeded_tree)

EXECUTOR = ("fsdp2", "data2", "fsdp2_tp2")
WORLD = {"fsdp2": 2, "data2": 2, "fsdp2_tp2": 4}


def jcfg(case):
    return jt.TransformerConfig(**W.model_fields(case), dtype=jnp.float32)


def _jax_executor(case, tree, path):
    """JAX's executor of ``case`` on its mesh: losses, whole optimizer
    chunks, embedding / head masters."""
    n = WORLD[case]
    je, *_ = deepspeed_tpu.initialize(
        model=jt.make_model(jcfg(case)), config=W.conf(case, path),
        devices=jax.devices()[:n])
    ex = je._infinity_exec
    assert je._infinity_multi and ex.dp == n // max(1, ex._TP)
    seed_jax_executor(ex, tree)
    gas = W.CASES[case][2]
    losses = [float(je.train_batch(b)["loss"]) for b in W.batches(gas)]
    out = {"losses": losses,
           "opt": [np.array(ex.store.read_opt(i))
                   for i in range(W.DIMS["num_layers"])],
           "nl_master": {k: np.asarray(o["master"]) for k, o in
                         jax.device_get(ex.nl_opt).items()}}
    ex.close()
    return out


def _jax_swapper(tree, path):
    """JAX's drained NVMe swapper at data=2 from ``tree``."""
    je, *_ = deepspeed_tpu.initialize(
        model=jt.make_model(jcfg("data2")), config=W.swap_conf(path),
        devices=jax.devices()[:2])
    je.state["params"] = jax.tree.map(
        lambda old, new: jax.device_put(jnp.asarray(new, old.dtype),
                                        old.sharding),
        je.state["params"], tree)
    je._swapper.initialize(je.state["params"])
    return [float(je.train_batch(b)["loss"]) for b in W.batches(2)]


def _port_one_rank(case, tree, root):
    """The port at one rank: losses, and tags after step 2 and 3."""
    gas = W.CASES[case][2]
    e = deepspeed_tpu_torch.initialize(
        model=tt.make_model(W.tcfg(case)),
        config=W.conf(case, os.path.join(root, "w1", case), world=False),
        params=tree, device="cpu")[0]
    losses = []
    for t, b in enumerate(W.batches(gas)):
        losses.append(float(e.train_batch(b)["loss"]))
        if t == 1:
            e.save_checkpoint(os.path.join(root, "w1", case), tag="mid")
    e.save_checkpoint(os.path.join(root, "w1", case), tag="end")
    out = {"losses": losses, "bytes": e.offload_bytes(),
           "chunk": e._infinity.chunk,
           "eval": float(e.eval_batch(W.batches(gas)[0]))}
    e.close()
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("inf_mesh"))
    trees = {c: seeded_tree(jcfg(c), seed=i)
             for i, c in enumerate(EXECUTOR)}
    one = {c: _port_one_rank(c, trees[c], root) for c in EXECUTOR}
    one["swap"] = _swap_one_rank(trees["data2"], root)
    one["host_adam"] = _swap_one_rank(trees["data2"], root, cpu_adam=True)
    resume = {"fsdp2": os.path.join(root, "w1", "fsdp2")}
    pool = concurrent.futures.ThreadPoolExecutor(1)

    def groups():
        two = run_group(W.group, 2, ["fsdp2", "data2", "swap_data2",
                                     "host_adam_data2", "refusals",
                                     "resume_fsdp2"],
                        trees, root, resume, threads=1)
        four = run_group(W.group, 4, ["fsdp2_tp2"], trees, root, resume,
                         threads=1)
        return {**two, **four}
    fut = pool.submit(groups)
    jax_runs = {c: _jax_executor(c, trees[c], os.path.join(root, "j", c))
                for c in EXECUTOR}
    jax_runs["swap"] = _jax_swapper(trees["data2"],
                                    os.path.join(root, "j", "swap"))
    ranks = fut.result()
    pool.shutdown()
    return {"root": root, "trees": trees, "one": one, "jax": jax_runs,
            "ranks": ranks}


def _swap_one_rank(tree, root, cpu_adam=False):
    name = "host_adam" if cpu_adam else "swap"
    e = deepspeed_tpu_torch.initialize(
        model=tt.make_model(W.tcfg("data2")),
        config=W.swap_conf(os.path.join(root, "w1", name), world=False,
                           cpu_adam=cpu_adam),
        params=tree, device="cpu")[0]
    losses = [float(e.train_batch(b)["loss"]) for b in W.batches(2)]
    if not cpu_adam:
        e.save_checkpoint(os.path.join(root, "w1", name), tag="end")
    out = {"losses": losses, "num_params": sum(
        t.numel() for t in e._swap_leaves(e.state["params"]))}
    e.close()
    return out


def _tag_chunks(tag_dir, layers):
    """A tag's whole optimizer chunks (3, C) and embedding / head
    masters."""
    shapes = os.path.join(tag_dir, "infinity_shapes.json")
    import json
    with open(shapes) as f:
        chunk = json.load(f)["chunk"]
    opt = [np.fromfile(os.path.join(tag_dir, "infinity_chunks",
                                    f"opt_{i}.bin"),
                       np.float32).reshape(3, chunk)
           for i in range(layers)]
    with np.load(os.path.join(tag_dir, "infinity_small.npz")) as z:
        nl = {k.split("__")[1]: z[k] for k in z.files
              if k.startswith("nl_opt__") and k.endswith("__master")}
    return opt, nl


@pytest.mark.parametrize("case", EXECUTOR)
def test_executor_on_a_mesh_matches_jax_and_one_rank(runs, case):
    """Losses and the masters after 3 steps: against JAX's executor on
    the same mesh and against the port at one rank (the gathered tag's
    whole chunks; a mesh pads its chunk to 128 x F x TP, the one-rank run
    to 128, so the layer's values are compared); the eval loss after
    them against one rank's."""
    got = runs["ranks"][case]
    want = runs["one"][case]["eval"]
    assert abs(got["eval"] - want) <= 1e-5 * abs(want)
    for ref in (runs["jax"][case]["losses"], runs["one"][case]["losses"]):
        for a, b in zip(got["losses"], ref):
            assert abs(a - b) <= 1e-5 * abs(b), (got["losses"], ref)
    L = W.DIMS["num_layers"]
    opt, nl = _tag_chunks(os.path.join(runs["root"], case, "end"), L)
    one, one_nl = _tag_chunks(os.path.join(runs["root"], "w1", case, "end"),
                              L)
    n = one[0].shape[1]
    for i in range(L):
        jx = runs["jax"][case]["opt"][i]
        m = min(jx.shape[1], opt[i].shape[1])
        assert rel_l2(opt[i][0, :m], jx[0, :m]) <= 1e-6, ("jax", i)
        assert rel_l2(opt[i][0, :n], one[i][0]) <= 1e-6, ("one rank", i)
    for k, ref in runs["jax"][case]["nl_master"].items():
        assert rel_l2(nl[k], ref) <= 1e-6, k
        assert rel_l2(nl[k], one_nl[k]) <= 1e-6, k


@pytest.mark.parametrize("case", EXECUTOR)
def test_each_rank_holds_its_shard(runs, case):
    """Every rank's store holds 1/(F x TP) of each whole chunk (padded to
    128 x F x TP): L x (2 + 12) x C_whole / (F x TP) bytes on disk, its
    own shard offset, and the same param reads a step as one rank."""
    _, mesh, gas, _ = W.CASES[case]
    n = mesh.get("fsdp", 1) * mesh.get("tensor", 1)
    ranks = runs["ranks"][case]["ranks"]
    L = W.DIMS["num_layers"]
    whole = ranks[0]["whole_chunk"]
    assert whole % (128 * n) == 0 and ranks[0]["chunk"] * n == whole
    for r in ranks:
        assert r["bytes"]["disk"] == L * 14 * whole // n
        assert r["param_reads"] == ranks[0]["param_reads"] == \
            _reads(L, gas)
    offs = sorted({r["offset"] for r in ranks})
    assert offs == [k * whole // n for k in range(n)]


def _reads(L, gas):
    """Param chunk copies to the card over the run: 2 L a micro-batch,
    and the first update's lazy init."""
    return W.STEPS * 2 * L * gas + L


def test_checkpoint_moves_between_fsdp_degrees(runs, tmp_path):
    """JAX's ``test_checkpoint_across_fsdp_degree``: a tag saved at fsdp=2
    after 2 steps loads at one rank and takes fsdp=2's third step; a
    one-rank tag loads at fsdp=2 (in the group) and takes the one-rank
    run's third step."""
    e = deepspeed_tpu_torch.initialize(
        model=tt.make_model(W.tcfg("fsdp2")),
        config=W.conf("fsdp2", tmp_path, world=False), device="cpu")[0]
    e.load_checkpoint(os.path.join(runs["root"], "fsdp2"), tag="mid")
    got = float(e.train_batch(W.batches(1)[2])["loss"])
    e.close()
    want = runs["ranks"]["fsdp2"]["losses"][2]
    assert abs(got - want) <= 1e-5 * abs(want)
    back = runs["ranks"]["resume_fsdp2"]
    want = runs["one"]["fsdp2"]["losses"][2]
    assert abs(back - want) <= 1e-5 * abs(want)


def test_sharded_nvme_swapper_at_data2_matches_jax_and_one_rank(runs):
    """The NVMe swapper at data=2: each rank swaps its ZeRO partition (half
    the state: every leaf of the model splits over 2; a tag saved after
    step 2 loads into a fresh pair of ranks, which take the same third
    step bit for bit),
    the losses equal JAX's drained swapper's on the same mesh and the
    one-rank swapper's, and the saved state (gathered whole) equals the
    one-rank run's."""
    got = runs["ranks"]["swap_data2"]
    for ref in (runs["jax"]["swap"], runs["one"]["swap"]["losses"]):
        for a, b in zip(got["losses"], ref):
            assert abs(a - b) <= 1e-5 * abs(b), (got["losses"], ref)
    assert got["resumed"] == got["losses"][2]
    held = [r["held"] for r in got["ranks"]]
    total = runs["one"]["swap"]["num_params"]
    assert all(h * 2 == total for h in held), (held, total)
    with np.load(os.path.join(runs["root"], "swap_data2", "end",
                              "optswap.npz")) as z:
        mesh = {k: z[k] for k in z.files}
    with np.load(os.path.join(runs["root"], "w1", "swap", "end",
                              "optswap.npz")) as z:
        one = {k: z[k] for k in z.files}
    assert sorted(mesh) == sorted(one)
    for k in one:
        assert rel_l2(mesh[k][0], one[k][0]) <= 1e-6, k


def test_host_adam_route_at_data2_matches_one_rank(runs):
    """The host-Adam route (``use_cpu_adam``) at data=2: each rank's C++
    update on its half of the state, the same losses as one rank's."""
    got = runs["ranks"]["host_adam_data2"]
    for a, b in zip(got["losses"], runs["one"]["host_adam"]["losses"]):
        assert abs(a - b) <= 1e-5 * abs(b)
    total = runs["one"]["host_adam"]["num_params"]
    assert [r["held"] * 2 for r in got["ranks"]] == [total, total]


def test_mesh_axes_jax_refuses_stay_refused(runs):
    """pipe, seq and expert raise JAX's ValueError; an executor on two
    ranks without ``mesh.axes`` raises (JAX's rule on hardware)."""
    got = runs["ranks"]["refusals"]
    for ax in ("pipe", "seq", "expert"):
        assert got[ax] is not None and "data/fsdp/tensor" in got[ax], got
    assert got["no_axes"] is not None and "mesh.axes" in got["no_axes"]


def test_a_ranks_cut_of_the_layer():
    """What a rank holds and runs, from the executor's tables (no group
    needed to build one): at one rank nothing is cut; at fsdp=2 x
    tensor=2 rank (f, t) keeps the chunk's shard f x 2 + t of a chunk
    padded to 128 x 4, and cuts wq's heads (its columns) and wo's rows
    at its tensor coordinate; a replicated leaf's grad is kept on tensor
    rank 0 only."""
    from deepspeed_tpu_torch.parallel import MeshPlan
    from deepspeed_tpu_torch.parallel.mesh import Mesh
    from deepspeed_tpu_torch.runtime.infinity import InfinityExecutor
    cfg = W.tcfg("fsdp2_tp2")
    ex = InfinityExecutor(cfg, device="cpu", backend="host")
    assert ex.whole_chunk == ex.chunk and ex.shard_offset == 0
    assert ex.chunk == -(-ex.layer_params // 128) * 128
    ex.close()
    H = cfg.hidden_size
    for rank in range(4):
        mesh = Mesh(MeshPlan(fsdp=2, tensor=2), rank=rank)
        f, t = mesh.index("fsdp"), mesh.index("tensor")
        ex = InfinityExecutor(cfg, device="cpu", backend="host", mesh=mesh)
        assert ex.whole_chunk == -(-ex.layer_params // 512) * 512
        assert ex.shard_offset == (f * 2 + t) * ex.chunk
        assert ex.chunk * 4 == ex.whole_chunk
        half = slice(t * H // 2, (t + 1) * H // 2)
        assert ex._tp_slices["wq"][1] == half
        assert ex._tp_slices["wo"][0] == half
        assert ex._tp_slices["ln1_scale"] == (slice(None),)
        keep = ex._tp_keep.numpy()
        assert keep.min() == (1.0 if t == 0 else 0.0) and keep.max() == 1.0
        ex.close()
