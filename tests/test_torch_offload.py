"""The port's optimizer-state tiers (ZeRO-Offload) against the JAX
package's: the host C++ (CPU-Adam, CPU-Adagrad) bit for bit against JAX's
binding of the same source, the async IO round trips, and each route of
``offload_optimizer`` engine against engine: the nvme swapper, the
chunk-streamed host tier, the host CPU-Adam / CPU-Adagrad and the eager
round trip of a non-Adam optimizer; then checkpoints, an injected read
fault, the drained swapper and the refusals.

Everything runs on the CPU (the pinned tier is the plain host tier here,
as in JAX's CPU runs). The same numpy-seeded weights go to both
packages. Tolerances: the copied C++ bit for bit; against the port's
torch AdamW / Adagrad relative L2 <= 1e-6 (Adam's v: the C++'s own f32
constant, below); engine losses within 1e-5
(relative) and final masters within 1e-6 relative L2 after 3 steps, of
JAX's engine and of the port's own on-device run. The Adam runs use eps
1e-3: with 1e-8 a grad within rounding of 0 flips the sign of its first
updates (Adam's first step is ~lr * sign(g)), and either package's float
noise in the grads alone moves the masters by ~1e-5 relative L2.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import transformer as jt
from deepspeed_tpu_torch.config import Config
from deepspeed_tpu_torch.models import transformer as tt
from deepspeed_tpu_torch.ops import host_build
from deepspeed_tpu_torch.ops.optimizers import tree_leaves

from tests import _torch_cpu  # noqa: F401  (torch threads under xdist)

V, S, B = 256, 32, 4
DIMS = dict(vocab_size=V, num_layers=2, max_seq_len=S, hidden_size=64,
            num_heads=4, num_kv_heads=2, intermediate_size=128)
JCFG = jt.llama_config("tiny", dtype=jnp.float32, **DIMS)
TCFG = tt.llama_config("tiny", dtype=torch.float32, **DIMS)
# a few chunks of the swapper (the model has 106,816 values)
CHUNK_BYTES = 4 * 40_000


def rel_l2(got, want):
    got = np.asarray(got, np.float64).ravel()
    want = np.asarray(want, np.float64).ravel()
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _conf(offload, opt="adamw", **extra):
    params = ({"lr": 1e-3, "eps": 1e-3} if opt in ("adamw", "adagrad")
              else {"lr": 1e-3})
    c = {"train_batch_size": B, "optimizer": {"type": opt, "params": params},
         "bf16": {"enabled": False}, "gradient_clipping": 0.5,
         "zero_optimization": {"stage": 1, "offload_optimizer": offload},
         "steps_per_print": 10 ** 6}
    c.update(extra)
    return c


def _batches(n=3, seed=0):
    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(0, V, (B, S), dtype=np.int32)}
            for _ in range(n)]


P0 = None


def _p0():
    global P0
    if P0 is None:
        P0 = jax.tree.map(np.asarray,
                          jt.make_model(JCFG).init(jax.random.PRNGKey(42)))
    return P0


def _port(conf):
    return deepspeed_tpu_torch.initialize(model=tt.make_model(TCFG),
                                          config=dict(conf), params=_p0(),
                                          device="cpu")[0]


def _flat_masters(state, n):
    """The f32 masters, flat in leaf order, from a swapper's export (its
    chunks' plane 0, or the host tier's ``master``)."""
    if "master" in state:
        return np.asarray(state["master"])
    return np.concatenate([state[f"chunk_{i}"][0]
                           for i in range(len(state))])[:n]


def _port_masters(te):
    if te._swapper is not None:
        return _flat_masters(te._swapper.export_state(),
                             te._swapper.num_params
                             if hasattr(te._swapper, "num_params")
                             else te._swapper.n)
    opt = te.state["opt"].get("master") or te.state["params"]
    return np.concatenate([t.detach().float().numpy().ravel()
                           for t in tree_leaves(opt)])


# JAX's engine of each route, run once (3 steps on _batches()): losses and
# final masters. The nvme run carries the fault test's schedule (a
# transient read fault it must absorb identically), and runs drained
# (``pipeline_read`` / ``pipeline_write`` off): JAX's pipelined swapper
# reads the next chunks into a host buffer that its CPU ``device_put`` may
# alias, so its masters depend on the heap's alignment and the thread
# timing (ROADMAP C10, ``test_jax_pipelined_swapper_races_on_an_aliased_
# read_buffer``). The drained swapper is the same math, and the port's
# pipelined and drained runs agree bit for bit
# (``test_pipelined_and_drained_swapper_identical``).
_JAX = {}
READ_FAULT = [{"kind": "io_error", "op": "aio_read", "at": 3, "times": 2,
               "errno": "EIO"}]
DRAINED = {"pipeline_read": False, "pipeline_write": False}


def _jax_run(route, tmp_path_factory):
    if route in _JAX:
        return _JAX[route]
    from deepspeed_tpu.robustness import faults as jf
    offload, opt = {
        "nvme": ({"device": "nvme", "buffer_size": CHUNK_BYTES}, "adamw"),
        "cpu_adam": ({"device": "cpu", "use_cpu_adam": True}, "adamw"),
        "cpu_adagrad": ({"device": "cpu", "use_cpu_adam": True},
                        "adagrad"),
        "eager": ({"device": "cpu"}, "sgd")}[route]
    if route == "nvme":
        offload.update(DRAINED)
        offload["nvme_path"] = str(tmp_path_factory.mktemp("jax_nvme"))
        injector = jf.install(jf.FaultInjector(jf.FaultSchedule(READ_FAULT)))
    try:
        je, *_ = deepspeed_tpu.initialize(
            model=jt.make_model(JCFG), config=_conf(offload, opt),
            devices=jax.devices()[:1])
        losses = [float(je.train_batch(b)["loss"]) for b in _batches()]
    finally:
        if route == "nvme":
            jf.install(None)
    if je._swapper is not None:
        n = sum(a.size for a in jax.tree.leaves(je.params))
        masters = _flat_masters(je._swapper.export_state(), n)
        je._swapper.close()
    else:
        masters = np.concatenate([np.asarray(a, np.float32).ravel()
                                  for a in jax.tree.leaves(je.params)])
    _JAX[route] = {"losses": losses, "masters": masters,
                   "fired": ([f["index"] for f in injector.fired]
                             if route == "nvme" else None)}
    return _JAX[route]


@pytest.fixture(autouse=True)
def _clean_faults():
    from deepspeed_tpu_torch.robustness import events, faults
    faults.clear()
    events.clear()
    yield
    faults.clear()
    events.clear()


# ---------------------------------------------------------------------------
# the host C++: the port's copy against JAX's binding, and against torch
# ---------------------------------------------------------------------------

def _state(n, seed):
    rng = np.random.default_rng(seed)
    master = rng.standard_normal(n).astype(np.float32)
    m = (rng.standard_normal(n) * 1e-3).astype(np.float32)
    v = np.abs(rng.standard_normal(n) * 1e-6).astype(np.float32)
    g = rng.standard_normal(n).astype(np.float32)
    return master, m, v, g


def _bf16_bits(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16)).view(np.uint16)


@pytest.mark.parametrize("wire", ["bf16", "f32"])
@pytest.mark.parametrize("adamw_mode", [True, False])
def test_cpu_adam_bit_for_bit_with_jax(wire, adamw_mode):
    from deepspeed_tpu.ops import cpu_adam as jca
    from deepspeed_tpu_torch.ops import cpu_adam as tca
    n = 10_007
    master, m, v, g = _state(n, 0)
    if wire == "bf16":
        g = _bf16_bits(g)
    outs = []
    for mod in (jca, tca):
        st = [master.copy(), m.copy(), v.copy()]
        out = np.empty(n, np.uint16 if wire == "bf16" else np.float32)
        for step in (1, 2, 3):
            mod.adam_step_flat(*st, g, step_num=step, lr=1e-3,
                               betas=(0.9, 0.999), eps=1e-8,
                               weight_decay=0.01, adamw_mode=adamw_mode,
                               grad_scale=0.37, out=out)
        outs.append(st + [out])
    for a, b in zip(*outs):
        assert np.array_equal(a.view(np.uint32 if a.dtype == np.float32
                                     else np.uint16),
                              b.view(np.uint32 if b.dtype == np.float32
                                     else np.uint16))
    assert host_build.CPU_ADAM.calls["dstpu_adam_step_" + wire] >= 3


@pytest.mark.parametrize("wire", ["bf16", "f32"])
def test_cpu_adagrad_bit_for_bit_with_jax(wire):
    from deepspeed_tpu.ops import cpu_adagrad as jcg
    from deepspeed_tpu_torch.ops import cpu_adagrad as tcg
    n = 10_007
    master, _, v, g = _state(n, 1)
    if wire == "bf16":
        g = _bf16_bits(g)
    outs = []
    for mod in (jcg, tcg):
        st = [master.copy(), v.copy()]
        out = np.empty(n, np.uint16 if wire == "bf16" else np.float32)
        for _ in range(3):
            mod.adagrad_step_flat(*st, g, lr=1e-2, eps=1e-10,
                                  weight_decay=0.01, grad_scale=0.5, out=out)
        outs.append(st + [out])
    for a, b in zip(*outs):
        assert a.tobytes() == b.tobytes()


def test_host_optimizers_match_torch_plain_versions():
    """CPU-Adam against ``ops/adam.fused_adam_update`` and CPU-Adagrad
    against ``ops/optimizers.adagrad`` on the same tensors, 3 steps. v
    carries the C++'s own constant: ``1.0f - beta2`` rounds 0.999 in f32
    first (0.00099998713, 1.29e-5 below the f32 of 1 - 0.999 that torch
    and JAX's device update use), so v is held to that and master and m
    to 1e-6."""
    from deepspeed_tpu_torch.ops.adam import fused_adam_update
    from deepspeed_tpu_torch.ops.cpu_adagrad import adagrad_step_flat
    from deepspeed_tpu_torch.ops.cpu_adam import adam_step_flat
    from deepspeed_tpu_torch.ops.optimizers import adagrad
    master, m, v, g = (torch.from_numpy(a) for a in _state(4099, 2))
    host = [master.clone(), m.clone(), v.clone()]
    plain = [master.clone(), m.clone(), v.clone()]
    for step in (1, 2, 3):
        adam_step_flat(*host, g, step_num=step, lr=1e-3, weight_decay=0.01,
                       grad_scale=0.5)
        fused_adam_update(*plain, g * 0.5, 1e-3, step, b1=0.9, b2=0.999,
                          eps=1e-8, wd=0.01, awm=True, bc=True)
    c2 = abs(float(np.float32(1) - np.float32(0.999)) - 0.001) / 0.001
    for a, b, tol in zip(host, plain, (1e-6, 1e-6, 1.01 * c2)):
        assert rel_l2(a, b) <= tol
    acc = torch.zeros_like(master)
    hm = master.clone()
    opt = adagrad(lr=1e-2, weight_decay=0.01, use_master_weights=False)
    params = {"w": master.clone()}
    state = opt.init(params)
    for _ in range(3):
        adagrad_step_flat(hm, acc, g, lr=1e-2, weight_decay=0.01)
        opt.update({"w": g}, state, params)
    assert rel_l2(hm, params["w"]) <= 1e-6
    assert rel_l2(acc, state["accum"]["w"]) <= 1e-6


def test_bf16_params_round_as_the_cast():
    """``out`` of a bf16 step is the updated master cast to bf16, round to
    nearest even, ties included (lr 0 leaves the masters as drawn)."""
    from deepspeed_tpu_torch.ops.cpu_adam import adam_step_flat
    rng = np.random.default_rng(3)
    hi = rng.integers(0, 0x7F7F, 4096).astype(np.uint32) << 16   # finite
    low = np.concatenate([np.full(1024, 0x8000), np.full(1024, 0x7FFF),
                          np.full(1024, 0x8001),
                          rng.integers(0, 1 << 16, 1024)]).astype(np.uint32)
    master = torch.from_numpy((hi | low).view(np.float32).copy())
    m, v = torch.zeros(4096), torch.zeros(4096)
    g = torch.zeros(4096, dtype=torch.bfloat16)
    out = torch.empty(4096, dtype=torch.bfloat16)
    adam_step_flat(master, m, v, g, step_num=1, lr=0.0, out=out)
    want = master.to(torch.bfloat16)
    assert torch.equal(out.view(torch.int16), want.view(torch.int16))


def test_sq_norm_matches_jax():
    from deepspeed_tpu.ops.cpu_adam import CPUAdam as JaxCPUAdam
    from deepspeed_tpu_torch.ops.cpu_adam import sq_norm
    g = _state(100_003, 4)[3]
    ja = JaxCPUAdam(4)
    for x in (g, _bf16_bits(g)):
        assert abs(sq_norm(x) - ja.sq_norm(x)) <= 1e-12 * ja.sq_norm(x)


def test_buffers_are_checked_before_the_cpp():
    from deepspeed_tpu_torch.ops.cpu_adam import adam_step_flat
    a = torch.zeros(16)
    with pytest.raises(ValueError, match="contiguous"):
        adam_step_flat(a, a.clone(), torch.zeros(32)[::2], a.clone(),
                       step_num=1, lr=1e-3)
    with pytest.raises(ValueError):
        adam_step_flat(a, a.clone(), torch.zeros(15), a.clone(),
                       step_num=1, lr=1e-3)


# ---------------------------------------------------------------------------
# aio (JAX's TestAIO)
# ---------------------------------------------------------------------------

def test_aio_roundtrip_offsets_and_unaligned_sizes(tmp_path):
    from deepspeed_tpu_torch.ops.aio import AIOHandle
    h = AIOHandle(block_size=1 << 12, queue_depth=8, thread_count=2)
    assert isinstance(h.uses_io_uring, bool)
    x = np.random.default_rng(0).standard_normal((100, 333)).astype(
        np.float32)
    p = str(tmp_path / "t.bin")
    h.pwrite(p, x)
    assert np.array_equal(h.pread(p, np.empty_like(x)), x)
    a, b = torch.arange(512, dtype=torch.int32), torch.arange(
        512, 1024, dtype=torch.int32)
    p = str(tmp_path / "o.bin")
    h.pwrite(p, a)
    h.pwrite(p, b, file_offset=a.numel() * 4)
    assert torch.equal(h.pread(p, torch.empty(1024, dtype=torch.int32)),
                       torch.arange(1024, dtype=torch.int32))
    u = np.frombuffer(np.random.default_rng(1).bytes(12345), np.uint8)
    p = str(tmp_path / "u.bin")
    h.pwrite(p, u)
    assert np.array_equal(h.pread(p, np.empty_like(u)), u)
    # what JAX's handle wrote, the port's reads
    from deepspeed_tpu.ops.aio import AIOHandle as JaxAIO
    JaxAIO().pwrite(str(tmp_path / "j.bin"), x)
    assert np.array_equal(h.pread(str(tmp_path / "j.bin"),
                                  np.empty_like(x)), x)
    # O_DIRECT takes whole pages of a buffer's own storage only
    with pytest.raises(ValueError, match="O_DIRECT"):
        h.pwrite(p, torch.zeros(2048)[1:1025], direct=True)
    h.close()


# ---------------------------------------------------------------------------
# the routes, engine against engine
# ---------------------------------------------------------------------------

ROUTES = {
    # route id: (offload section, optimizer, JAX's run to hold it to)
    "nvme": ({"device": "nvme", "buffer_size": CHUNK_BYTES}, "adamw",
             "nvme"),
    "host": ({"device": "cpu", "buffer_size": CHUNK_BYTES}, "adamw",
             "nvme"),
    "cpu_adam": ({"device": "cpu", "use_cpu_adam": True}, "adamw",
                 "cpu_adam"),
    "cpu_adagrad": ({"device": "cpu", "use_cpu_adam": True}, "adagrad",
                    "cpu_adagrad"),
    "eager": ({"device": "cpu"}, "sgd", "eager"),
}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_route_matches_jax_and_the_on_device_run(route, tmp_path,
                                                 tmp_path_factory):
    """3 steps of each route against JAX's engine in the same config, and
    against the port's own run without offload (the "host" route, JAX's
    chunk-streamed tier, is held to JAX's nvme run: one swapper class)."""
    offload, opt, jax_route = ROUTES[route]
    offload = dict(offload)
    if offload["device"] == "nvme":
        offload["nvme_path"] = str(tmp_path)
    te = _port(_conf(offload, opt))
    assert te._offload == route.replace("cpu_adagrad", "cpu_adam")
    if route != "eager":
        assert te.state["opt"] is None
    losses = [float(te.train_batch(b)["loss"]) for b in _batches()]
    want = _jax_run(jax_route, tmp_path_factory)
    for got, ref in zip(losses, want["losses"]):
        assert abs(got - ref) <= 1e-5 * abs(ref)
    masters = _port_masters(te)
    assert rel_l2(masters, want["masters"]) <= 1e-6
    plain = _port(_conf({}, opt))
    for b in _batches():
        plain.train_batch(b)
    assert rel_l2(masters, _port_masters(plain)) <= 1e-6
    by_tier = te.offload_bytes()
    n = masters.size
    if route in ("nvme", "host"):
        assert by_tier["device"] == 4 * n
        chunks = te._swapper.n_chunks * te._swapper.chunk
        assert by_tier["disk" if route == "nvme" else "host"] == 12 * chunks
    te.close()


def test_mid_step_read_fault_recovers_identically(tmp_path,
                                                  tmp_path_factory):
    """A transient EIO on the 4th chunk read (twice: retry_io makes 4
    attempts) is absorbed: the same numbers as a run without it, the
    fault fired at the same read in both packages, and a
    ``fault_recovered`` event."""
    from deepspeed_tpu_torch.robustness import events, faults
    conf = _conf({"device": "nvme", "buffer_size": CHUNK_BYTES,
                  "nvme_path": str(tmp_path / "ref")})
    ref = _port(conf)
    want = [float(ref.train_batch(b)["loss"]) for b in _batches()]
    want_m = _port_masters(ref)
    ref.close()
    injector = faults.install(faults.FaultInjector(
        faults.FaultSchedule(READ_FAULT)))
    conf["zero_optimization"]["offload_optimizer"]["nvme_path"] = str(
        tmp_path / "got")
    te = _port(conf)
    got = [float(te.train_batch(b)["loss"]) for b in _batches()]
    assert got == want
    assert np.array_equal(_port_masters(te), want_m)
    assert [f["index"] for f in injector.fired] == [3, 4]
    assert events.history("fault_recovered")
    assert [f["index"] for f in injector.fired] == \
        _jax_run("nvme", tmp_path_factory)["fired"]
    te.close()


def test_pipelined_and_drained_swapper_identical(tmp_path):
    runs = []
    for pipe in (True, False):
        conf = _conf({"device": "nvme", "buffer_size": CHUNK_BYTES,
                      "nvme_path": str(tmp_path / str(pipe)),
                      "pipeline_read": pipe, "pipeline_write": pipe})
        te = _port(conf)
        assert te._swapper.pipeline is pipe
        losses = [float(te.train_batch(b)["loss"]) for b in _batches()]
        runs.append((losses, te._swapper.export_state()))
        te.close()
    (la, sa), (lb, sb) = runs
    assert la == lb
    assert all(np.array_equal(sa[k], sb[k]) for k in sa)


def _aligned_like(buf, offset):
    """A float32 array of ``buf``'s shape starting ``offset`` bytes past a
    64-byte boundary."""
    raw = np.empty(buf.size * 4 + 128, np.uint8)
    at = (-raw.ctypes.data) % 64 + offset
    return raw[at:at + buf.size * 4].view(np.float32).reshape(buf.shape)


def test_jax_pipelined_swapper_races_on_an_aliased_read_buffer(tmp_path):
    """ROADMAP C10, a reference defect. JAX's pipelined swapper
    ``device_put``s its reused numpy read buffer i % 2, dispatches chunk
    i's update asynchronously, and its read thread then fills the same
    buffer with chunk i + 2 (``deepspeed_tpu/runtime/swap_tensor.py``,
    ``step``), without waiting for the transfer. JAX's CPU ``device_put``
    of a 64-byte-aligned array is zero-copy (of another, an asynchronous
    copy that the next read can still overtake), so whether chunk i's
    update reads its own state or chunk i + 2's depends on where the heap
    put the buffer and on the timing. The swapper's own sequence, on its
    own sharding and an aligned buffer: the array put on the device turns
    into chunk 2's state once chunk 2 is read."""
    offload = {"device": "nvme", "buffer_size": CHUNK_BYTES,
               "nvme_path": str(tmp_path)}
    je, *_ = deepspeed_tpu.initialize(
        model=jt.make_model(JCFG), config=_conf(offload, "adamw"),
        devices=jax.devices()[:1])
    sw = je._swapper
    assert sw.pipeline and sw.n_chunks == 3
    je.train_batch(_batches(1)[0])
    buf = _aligned_like(sw._read_bufs[0], 0)
    chunk0 = sw._read_file(0, buf).copy()
    on_device = jax.device_put(buf, sw._buf_sharding)
    chunk2 = sw._read_file(2, buf).copy()
    sw.close()
    assert not np.array_equal(chunk0, chunk2)
    assert np.array_equal(np.asarray(on_device), chunk2)


@pytest.mark.parametrize("route", ["nvme", "cpu_adam"])
def test_save_load_resumes_bit_for_bit(route, tmp_path):
    """2 steps, save, 2 more; a fresh engine loads the tag and its 2
    steps are the uninterrupted run's bit for bit. ``zero_to_fp32`` of the
    tag gives the saved masters; the integrity manifest covers
    ``optswap.npz``."""
    from deepspeed_tpu_torch.robustness import integrity
    from deepspeed_tpu_torch.utils.zero_to_fp32 import \
        get_fp32_state_dict_from_zero_checkpoint
    offload = dict(ROUTES[route][0], nvme_path=str(tmp_path / "swap"))
    conf = _conf(offload)
    batches = _batches(4, seed=5)
    te = _port(conf)
    for b in batches[:2]:
        te.train_batch(b)
    ck = str(tmp_path / "ck")
    te.save_checkpoint(ck, tag="t")
    saved = _port_masters(te)
    want = [float(te.train_batch(b)["loss"]) for b in batches[2:]]
    want_m = _port_masters(te)
    te.close()
    with open(os.path.join(ck, "t", integrity.MANIFEST_FILE)) as f:
        assert "optswap.npz" in f.read()
    sd = get_fp32_state_dict_from_zero_checkpoint(ck)
    flat = np.concatenate([sd[k].ravel() for k in sorted(sd)])
    assert np.array_equal(flat, saved)
    fresh = _port(dict(conf, zero_optimization={
        "stage": 1, "offload_optimizer": dict(
            offload, nvme_path=str(tmp_path / "swap2"))}))
    fresh.load_checkpoint(ck)
    got = [float(fresh.train_batch(b)["loss"]) for b in batches[2:]]
    assert got == want
    assert np.array_equal(_port_masters(fresh), want_m)
    fresh.close()


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

def test_broken_host_build_raises(tmp_path, monkeypatch):
    """No fallback: a host library that does not build raises, in the
    builder and through ``initialize``."""
    monkeypatch.setattr(host_build._build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(host_build, "CXX", str(tmp_path / "no-g++"))
    monkeypatch.setattr(host_build.CPU_ADAM, "_lib", None)
    with pytest.raises(RuntimeError, match="dstpu_cpu_adam"):
        host_build.CPU_ADAM.lib()
    with pytest.raises(RuntimeError, match="dstpu_cpu_adam"):
        _port(_conf({"device": "cpu", "use_cpu_adam": True}))


def test_offload_refusals(tmp_path):
    # a mesh of more ranks loads (A8d: the swappers hold each rank's ZeRO
    # partition, held in test_torch_infinity_mesh.py)
    c = Config.load({"zero_optimization": {
        "stage": 1, "offload_optimizer": {"device": "cpu"}},
        "mesh": {"axes": {"data": 2}}})
    assert c.zero_optimization.offloaded and c.mesh.axes == {"data": 2}
    with pytest.raises(ValueError, match="nvme_path"):
        _port(_conf({"device": "nvme"}))
    with pytest.raises(ValueError, match="Adam family"):
        _port(_conf({"device": "nvme", "nvme_path": str(tmp_path)},
                    opt="sgd"))
    with pytest.raises(ValueError, match="use_cpu_adam"):
        _port(_conf({"device": "cpu", "use_cpu_adam": True}, opt="lion"))
    with pytest.raises(Exception, match="offload_param requires zero "
                                        "stage 3"):
        Config.load({"zero_optimization": {"offload_param": {
            "device": "cpu"}}})
