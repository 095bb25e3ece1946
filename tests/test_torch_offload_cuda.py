"""The capacity tier on the card: each offload route at 2 layers in f32
against the port's on-device engine (the same model and batches), the
side-stream copies of the swapper and the executor (pipelined and drained
runs bit for bit), the layer executor's kernel launches against their
formula, and pinned, page-aligned aio buffers. Every test here needs an
NVIDIA GPU (marker ``cuda``) and skips without one; this file imports
neither jax nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_offload_cuda.py
"""

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch.models import transformer as tt
from deepspeed_tpu_torch.ops import _build
from deepspeed_tpu_torch.ops.optimizers import tree_leaves

V, S, B = 512, 128, 4
CFG = tt.llama_config("tiny", num_layers=2, vocab_size=V, max_seq_len=S,
                      dtype=torch.float32)


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (a CUDA kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def rel_l2(a, b):
    a = torch.as_tensor(a).double().cpu().ravel()
    b = torch.as_tensor(b).double().cpu().ravel()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def _params():
    """Seeded weights as a JAX-layout tree of numpy arrays, the layers
    rounded to bf16 (what the layer executor stores)."""
    p = tt.init_params(CFG, torch.Generator().manual_seed(0), "cpu",
                       dtype=torch.float32)
    out = {k: v.numpy() for k, v in p.items() if k != "layers"}
    out["layers"] = {k: v.to(torch.bfloat16).float().numpy()
                     for k, v in p["layers"].items()}
    return out


def _conf(zero, opt="adamw"):
    params = ({"lr": 1e-3, "eps": 1e-3} if opt in ("adamw", "adagrad")
              else {"lr": 1e-3})
    return {"train_batch_size": B, "bf16": {"enabled": False},
            "optimizer": {"type": opt, "params": params},
            "gradient_clipping": 0.5, "zero_optimization": zero}


def _batches(n):
    rng = np.random.default_rng(0)
    return [{"input_ids": torch.from_numpy(
        rng.integers(0, V, (B, S), dtype=np.int32)).cuda()}
        for _ in range(n)]


def _masters(e):
    if e._swapper is not None:
        st = e._swapper.export_state()
        if "master" in st:
            return torch.from_numpy(st["master"])
        flat = np.concatenate([st[f"chunk_{i}"][0] for i in range(len(st))])
        return torch.from_numpy(flat[:e._swapper.num_params])
    opt = e.state["opt"].get("master") or e.state["params"]
    return torch.cat([t.detach().float().cpu().ravel()
                      for t in tree_leaves(opt)])


ROUTES = {"nvme": ({"device": "nvme", "buffer_size": 4 << 20}, "adamw"),
          "pinned": ({"device": "cpu", "buffer_size": 4 << 20}, "adamw"),
          "cpu_adam": ({"device": "cpu", "use_cpu_adam": True}, "adamw"),
          "cpu_adagrad": ({"device": "cpu", "use_cpu_adam": True},
                          "adagrad"),
          "eager": ({"device": "cpu"}, "sgd")}


@pytest.mark.cuda
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_optimizer_routes_match_the_on_device_engine(cuda, route, tmp_path):
    offload, opt = ROUTES[route]
    offload = dict(offload, nvme_path=str(tmp_path))
    init = deepspeed_tpu_torch.initialize
    e = init(model=tt.make_model(CFG), params=_params(),
             config=_conf({"stage": 1, "offload_optimizer": offload}, opt))[0]
    ref = init(model=tt.make_model(CFG), params=_params(),
               config=_conf({"stage": 1}, opt))[0]
    for b in _batches(3):
        got, want = e.train_batch(b), ref.train_batch(b)
        assert abs(float(got["loss"]) - float(want["loss"])) <= \
            1e-5 * abs(float(want["loss"]))
    assert rel_l2(_masters(e), _masters(ref)) <= 1e-6
    tiers = e.offload_bytes()
    if route != "eager":
        assert tiers["device"] == 4 * _masters(e).numel()
    e.close()


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["nvme", "pinned", "infinity"])
def test_side_stream_copies_leave_the_numbers_alone(cuda, route, tmp_path):
    """Pipelined (reads, copies to and from the card on side streams,
    write-behind) and drained runs agree bit for bit."""
    runs = []
    for pipe in (True, False):
        knobs = {"pipeline_read": pipe, "pipeline_write": pipe,
                 "nvme_path": str(tmp_path / str(pipe))}
        if route == "infinity":
            zero = {"stage": 3,
                    "offload_param": dict(knobs, device="nvme"),
                    "offload_optimizer": dict(knobs, device="nvme")}
        else:
            zero = {"stage": 1, "offload_optimizer": dict(
                knobs, device="cpu" if route == "pinned" else "nvme",
                buffer_size=4 << 20)}
        e = deepspeed_tpu_torch.initialize(model=tt.make_model(CFG),
                                           params=_params(),
                                           config=_conf(zero))[0]
        losses = [float(e.train_batch(b)["loss"]) for b in _batches(3)]
        if route == "infinity":
            ex = e._infinity
            state = [ex.store.read(k, i).view(torch.uint8).clone()
                     for i in range(2) for k in ("param", "opt")]
        else:
            state = [_masters(e)] + [
                t.detach().cpu().clone() for t in tree_leaves(e.params)]
        runs.append((losses, state))
        e.close()
    assert runs[0][0] == runs[1][0]
    for a, b in zip(runs[0][1], runs[1][1]):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("cpu_adam", [False, True])
def test_layer_executor_step_and_launches(cuda, cpu_adam, tmp_path):
    """One streamed step against the monolithic engine on the same
    (bf16-exact) weights at 2 micro-batches: the loss, every master, and
    the kernels' launches: B1 = 2 x layers x gas (the forward and the
    backward's recompute), B2 = B3 = layers x gas."""
    gas, L = 2, CFG.num_layers
    conf = _conf({"stage": 3,
                  "offload_param": {"device": "nvme",
                                    "nvme_path": str(tmp_path)},
                  "offload_optimizer": {"device": "nvme",
                                        "nvme_path": str(tmp_path),
                                        "use_cpu_adam": cpu_adam}})
    conf.update(train_batch_size=B * gas, gradient_accumulation_steps=gas)
    e = deepspeed_tpu_torch.initialize(model=tt.make_model(CFG),
                                       params=_params(), config=conf)[0]
    rng = np.random.default_rng(1)
    batch = {"input_ids": torch.from_numpy(
        rng.integers(0, V, (B * gas, S), dtype=np.int32)).cuda()}
    _build.reset_launch_counts()
    loss = float(e.train_batch(batch)["loss"])
    counts = _build.launch_counts()
    assert counts["flash_fwd"] == 2 * L * gas
    assert counts["flash_bwd_dq"] == counts["flash_bwd_dkv"] == L * gas
    conf["zero_optimization"] = {"stage": 0}
    mono = deepspeed_tpu_torch.initialize(model=tt.make_model(CFG),
                                          params=_params(), config=conf)[0]
    want = float(mono.train_batch(batch)["loss"])
    assert abs(loss - want) <= 1e-5 * abs(want)
    names = sorted(mono.params["layers"])
    for i in range(L):
        flat = e._infinity.store.read("opt", i)[0]
        ref = torch.cat([mono.params["layers"][n][i].reshape(-1)
                         for n in names])
        assert rel_l2(flat[:ref.numel()], ref.detach()) <= 1e-6
    e.close()


@pytest.mark.cuda
def test_pinned_aligned_aio_buffers(cuda, tmp_path):
    """An aligned buffer is pinned (copies to and from the card), and
    O_DIRECT writes and reads it whole."""
    from deepspeed_tpu_torch.ops.aio import AIOHandle, aligned_buffer
    buf = aligned_buffer(3 << 20)
    assert buf.pinned and buf.addr % 4096 == 0
    x = buf.view(torch.float32, (3 << 18,))
    src = torch.randn(3 << 18, device="cuda")
    x.copy_(src, non_blocking=True)
    torch.cuda.synchronize()
    h = AIOHandle()
    p = str(tmp_path / "d.bin")
    h.pwrite(p, x, direct=True)
    back = aligned_buffer(3 << 20)
    y = back.view(torch.float32, (3 << 18,))
    h.pread(p, y, direct=True)
    assert torch.equal(y.cuda(non_blocking=True), src)
    h.close()
    buf.free()
    back.free()
