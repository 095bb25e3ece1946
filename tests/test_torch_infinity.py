"""ZeRO-Infinity layer streaming (``runtime/infinity.py``) against the JAX
package's ``InfinityExecutor`` and against the port's own monolithic
engine: the streamed step (gas 2, clip, the device AdamW and the host
CPU-Adam), its checkpoints, the drained executor and a seeded
interleaving of its IO threads, the fp16 loss scaler, the routing and the
refusals.

Everything runs on the CPU. JAX's executor draws its own weights; they
are read back from its store and handed to the port (``params=``), so
both start from the same bf16 layer chunks. Tolerances: losses within
1e-5 (relative), masters within 1e-6 relative L2; pipelined and drained
runs and a resumed run bit for bit. Adam's eps is 1e-3, as in
``test_torch_offload.py``.
"""

import dataclasses
import os
import time

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import transformer as jt
from deepspeed_tpu_torch.config import Config
from deepspeed_tpu_torch.models import transformer as tt
from deepspeed_tpu_torch.runtime import infinity as port_inf

from tests import _torch_cpu  # noqa: F401  (torch threads under xdist)

V, S, B, GAS = 256, 32, 4, 2
DIMS = dict(vocab_size=V, num_layers=2, max_seq_len=S, hidden_size=64,
            num_heads=4, num_kv_heads=2, intermediate_size=128)
JCFG = jt.llama_config("tiny", dtype=jnp.float32, **DIMS)
TCFG = tt.llama_config("tiny", dtype=torch.float32, **DIMS)


def rel_l2(got, want):
    got = np.asarray(got, np.float64).ravel()
    want = np.asarray(want, np.float64).ravel()
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _conf(path, cpu_adam=False, pipe=True, param="nvme", opt="nvme",
          **extra):
    c = {"train_batch_size": B * GAS, "train_micro_batch_size_per_gpu": B,
         "gradient_accumulation_steps": GAS,
         "optimizer": {"type": "adamw", "params": {"lr": 1e-3, "eps": 1e-3}},
         "bf16": {"enabled": False}, "gradient_clipping": 0.5,
         "zero_optimization": {
             "stage": 3,
             "offload_param": {"device": param, "nvme_path": str(path),
                               "pipeline_read": pipe,
                               "pipeline_write": pipe},
             "offload_optimizer": {"device": opt, "nvme_path": str(path),
                                   "use_cpu_adam": cpu_adam}},
         "steps_per_print": 10 ** 6}
    c.update(extra)
    return c


def _batches(n=3, seed=0, rows=B * GAS):
    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(0, V, (rows, S), dtype=np.int32)}
            for _ in range(n)]


_JAX = {}


def _jax_run(tmp_path_factory):
    """JAX's executor, once: its initial weights (as a params tree), 3
    steps' losses, each layer's final optimizer chunk, the embedding /
    head masters, and a checkpoint of the end state."""
    if _JAX:
        return _JAX
    root = tmp_path_factory.mktemp("jax_inf")
    je, *_ = deepspeed_tpu.initialize(
        model=jt.make_model(JCFG), config=_conf(root / "swap"),
        devices=jax.devices()[:1])
    ex = je._infinity_exec
    names = sorted(jt.init_params(jax.random.PRNGKey(0), JCFG)["layers"])
    layers = []
    for i in range(JCFG.num_layers):
        flat = ex.store.read_param(i).view(ml_dtypes.bfloat16).astype(
            np.float32)
        off, d = 0, {}
        for name, size, shape in zip(names, ex._sizes, ex._shapes):
            d[name] = flat[off:off + size].reshape(shape)
            off += size
        layers.append(d)
    params = {k: np.array(v, np.float32)
              for k, v in jax.device_get(ex.nl_params).items()}
    params["layers"] = {k: np.stack([lay[k] for lay in layers])
                        for k in names}
    losses = [float(je.train_batch(b)["loss"]) for b in _batches()]
    ckpt = str(root / "ckpt")
    je.save_checkpoint(ckpt, tag="end")
    from deepspeed_tpu.utils.zero_to_fp32 import \
        get_fp32_state_dict_from_zero_checkpoint as jax_fp32
    _JAX.update(params=params, losses=losses, ckpt=ckpt,
                opt=[np.array(ex.store.read_opt(i))
                     for i in range(JCFG.num_layers)],
                nl_master={k: np.asarray(o["master"]) for k, o in
                           jax.device_get(ex.nl_opt).items()},
                fp32=jax_fp32(ckpt, "end"))
    ex.close()
    return _JAX


def _port(conf, params):
    return deepspeed_tpu_torch.initialize(
        model=tt.make_model(TCFG), config=dict(conf), params=params,
        device="cpu")[0]


def _store_bytes(ex):
    out = []
    for i in range(ex.cfg.num_layers):
        for kind in ("param", "opt"):
            t = ex.store.read(kind, i)
            out.append(None if t is None else port_inf._view_bytes(t).copy())
    return out


@pytest.mark.parametrize("cpu_adam", [False, True])
def test_executor_matches_jax_executor(cpu_adam, tmp_path, tmp_path_factory):
    """3 streamed steps (gas 2, clip 0.5) against JAX's executor from the
    same chunks: losses, every layer's optimizer chunk and the embedding /
    head masters. With ``use_cpu_adam`` the layers update in the host C++
    (JAX's run updates them on the device: the same AdamW). m and v are
    held too: to 1e-5 on the device, and to 1e-4 from the C++, whose f32
    constants ``1.0f - beta2`` (1.29e-5 below 1 - 0.999) and ``1.0f -
    beta1`` move v by 1.3e-5 a step and, through the masters' path, m by
    ~4e-5 after 3 steps (``test_torch_offload.py`` holds one step of it
    against torch's AdamW)."""
    want = _jax_run(tmp_path_factory)
    te = _port(_conf(tmp_path, cpu_adam=cpu_adam), want["params"])
    ex = te._infinity
    assert ex.native is cpu_adam and ex.store.backend == "nvme"
    losses = [float(te.train_batch(b)["loss"]) for b in _batches()]
    for got, ref in zip(losses, want["losses"]):
        assert abs(got - ref) <= 1e-5 * abs(ref)
    for i, ref in enumerate(want["opt"]):
        got = ex.store.read("opt", i).numpy()
        assert rel_l2(got[0], ref[0]) <= 1e-6
        assert rel_l2(got[1:], ref[1:]) <= (1e-4 if cpu_adam else 1e-5)
    for k, ref in want["nl_master"].items():
        assert rel_l2(ex.nl_opt[k]["master"], ref) <= 1e-6
    assert te.global_steps == 3 and te.micro_steps == 3 * GAS
    te.close()


def test_zero_to_fp32_reads_the_jax_infinity_tag(tmp_path_factory):
    from deepspeed_tpu_torch.utils.zero_to_fp32 import \
        get_fp32_state_dict_from_zero_checkpoint
    want = _jax_run(tmp_path_factory)
    got = get_fp32_state_dict_from_zero_checkpoint(want["ckpt"], "end")
    assert sorted(got) == sorted(want["fp32"])
    for k, v in want["fp32"].items():
        assert np.array_equal(got[k], np.asarray(v, np.float32)), k


def test_one_step_matches_the_monolithic_engine(tmp_path, monkeypatch,
                                                tmp_path_factory):
    """One streamed step against the port's monolithic engine on the same
    (bf16-exact) weights: the loss, every master, and the layer's forward
    run twice a layer a micro-batch (the forward and the recompute of the
    backward: on the card B1 = 2 x layers x gas, B2 = B3 = layers x
    gas)."""
    params = _jax_run(tmp_path_factory)["params"]
    calls = [0]
    attention = tt.attention

    def counted(*a, **k):
        calls[0] += 1
        return attention(*a, **k)
    te = _port(_conf(tmp_path), params)
    batch = _batches(1, seed=3)[0]
    monkeypatch.setattr(tt, "attention", counted)
    loss = float(te.train_batch(batch)["loss"])
    monkeypatch.setattr(tt, "attention", attention)
    assert calls[0] == 2 * TCFG.num_layers * GAS
    mono = _port(_conf(tmp_path, zero_optimization={"stage": 0}), params)
    want = float(mono.train_batch(batch)["loss"])
    assert abs(loss - want) <= 1e-5 * abs(want)
    ex, names = te._infinity, sorted(params["layers"])
    for i in range(TCFG.num_layers):
        flat = ex.store.read("opt", i)[0]
        want_flat = torch.cat([mono.params["layers"][n][i].reshape(-1)
                               for n in names])
        assert rel_l2(flat[:want_flat.numel()], want_flat.detach()) <= 1e-6
    for k, o in ex.nl_opt.items():
        assert rel_l2(o["master"], mono.params[k].detach()) <= 1e-6
    ev = _batches(1, seed=4, rows=3)[0]
    assert abs(float(te.eval_batch(ev)) - float(mono.eval_batch(ev))) <= \
        1e-5 * float(mono.eval_batch(ev))
    dec = ex.measure_decomposition(batch, reps=1)
    assert dec["offload_layer_ms"] > 0 and dec["offload_update_ms"] > 0
    te.close()


@pytest.mark.parametrize("cpu_adam", [False, True])
def test_save_load_resumes_bit_for_bit(cpu_adam, tmp_path, tmp_path_factory):
    """2 steps, save, 2 more; a fresh executor loads the tag and its 2
    steps are the uninterrupted run's bit for bit (losses and every
    chunk). ``zero_to_fp32`` of the tag gives the saved masters."""
    from deepspeed_tpu_torch.utils.zero_to_fp32 import \
        get_fp32_state_dict_from_zero_checkpoint
    params = _jax_run(tmp_path_factory)["params"]
    batches = _batches(4, seed=7)
    te = _port(_conf(tmp_path / "a", cpu_adam=cpu_adam), params)
    for b in batches[:2]:
        te.train_batch(b)
    ck = str(tmp_path / "ck")
    te.save_checkpoint(ck, tag="mid")
    ex = te._infinity
    saved = [ex.store.read("opt", i)[0].clone() for i in range(2)]
    saved_nl = {k: o["master"].clone() for k, o in ex.nl_opt.items()}
    want = [float(te.train_batch(b)["loss"]) for b in batches[2:]]
    want_bytes = _store_bytes(ex)
    te.close()
    sd = get_fp32_state_dict_from_zero_checkpoint(ck)
    names = sorted(params["layers"])
    for i in range(2):
        flat = np.concatenate([sd[f"layers/{n}"][i].ravel() for n in names])
        assert np.array_equal(flat, saved[i][:flat.size].numpy())
    for k, v in saved_nl.items():
        assert np.array_equal(sd[k], v.numpy())
    fresh = _port(_conf(tmp_path / "b", cpu_adam=cpu_adam), params)
    fresh.load_checkpoint(ck)
    assert fresh.global_steps == 2
    got = [float(fresh.train_batch(b)["loss"]) for b in batches[2:]]
    assert got == want
    for a, b in zip(_store_bytes(fresh._infinity), want_bytes):
        assert np.array_equal(a, b)
    fresh.close()


@pytest.mark.parametrize("cpu_adam", [False, True])
def test_pipelined_drained_and_interleaved_identical(cpu_adam, tmp_path,
                                                     monkeypatch,
                                                     tmp_path_factory):
    """The pipelined executor (prefetch two layers ahead, write-behind two
    deep), the drained one, and the pipelined one with every store read
    and write delayed by a seeded random 0-3 ms (other interleavings of
    its threads): the same losses and chunk bytes, bit for bit."""
    params = _jax_run(tmp_path_factory)["params"]
    runs = []
    for name, pipe, delay in (("pipe", True, False), ("drained", False,
                                                      False),
                              ("jitter", True, True)):
        if delay:
            rng = np.random.default_rng(11)
            for meth in ("read", "write"):
                orig = getattr(port_inf.LayerStore, meth)

                def slow(self, *a, orig=orig, **k):
                    time.sleep(float(rng.uniform(0, 3e-3)))
                    return orig(self, *a, **k)
                monkeypatch.setattr(port_inf.LayerStore, meth, slow)
        te = _port(_conf(tmp_path / name, cpu_adam=cpu_adam, pipe=pipe),
                   params)
        assert te._infinity.pipeline is pipe
        losses = [float(te.train_batch(b)["loss"]) for b in _batches()]
        runs.append((losses, _store_bytes(te._infinity)))
        te.close()
    for losses, chunks in runs[1:]:
        assert losses == runs[0][0]
        for a, b in zip(chunks, runs[0][1]):
            assert np.array_equal(a, b)


def test_fp16_overflow_skips_and_the_scaler_follows_jax(tmp_path,
                                                        tmp_path_factory):
    """fp16 (f16 compute, bf16 storage): a step whose scaled grads
    overflow writes nothing and halves the scale (hysteresis 1); the next
    step trains. The host scaler follows JAX's ``_on_overflow`` /
    ``_on_good_step`` step for step."""
    from deepspeed_tpu.runtime.infinity import InfinityExecutor as JaxEx
    params = _jax_run(tmp_path_factory)["params"]
    fp16 = {"enabled": True, "initial_scale_power": 8, "hysteresis": 1,
            "loss_scale_window": 2}
    te = deepspeed_tpu_torch.initialize(
        model=tt.make_model(dataclasses.replace(TCFG, dtype=torch.float16)),
        config=_conf(tmp_path, fp16=fp16), params=params, device="cpu")[0]
    ex = te._infinity
    before = _store_bytes(ex)
    ex._scale = 2.0 ** 40
    m = te.train_batch(_batches(1)[0])
    assert bool(m["overflow"]) and ex._scale == 2.0 ** 39
    assert ex.applied_steps == 0 and te.skipped_steps == 1
    for a, b in zip(_store_bytes(ex), before):
        assert (a is None and b is None) or np.array_equal(a, b)
    ex._scale = 256.0
    m = te.train_batch(_batches(1, seed=1)[0])
    assert not bool(m["overflow"]) and np.isfinite(float(m["loss"]))
    assert ex.applied_steps == 1 and ex.store.read("opt", 0) is not None
    te.close()
    ns = type("S", (), {})()
    for o in (ns, ex):
        o._dynamic_scale, o._scale, o._scale_window = True, 1024.0, 2
        o._min_scale, o._hysteresis, o._good_steps, o._hyst_left = \
            1.0, 2, 0, 2
    for event in "ogggoogggo":
        for o, on in ((ns, JaxEx), (ex, type(ex))):
            (on._on_overflow if event == "o" else on._on_good_step)(o)
        assert (ex._scale, ex._good_steps, ex._hyst_left) == \
            (ns._scale, ns._good_steps, ns._hyst_left)


def test_routing_and_refusals(tmp_path):
    """Every offload_param goes to the executor (mixed cpu / nvme tiers
    keep their chunks on nvme; cpu alone is the host tier here); a family
    model and compression stream (A11, ported: their parity is in
    ``test_torch_infinity_compose.py``) and a mesh config loads (A8d,
    ``test_torch_infinity_mesh.py``); what it cannot stream raises: a
    model with ``attn_windows`` or experts (JAX's refusals), another
    optimizer, PLD (A11, the extras JAX's executor ignores)."""
    params = None
    e = _port(_conf(tmp_path, param="cpu", opt="nvme"), params)
    assert e._offload == "infinity" and e._infinity.store.backend == "nvme"
    e.close()
    e = _port(_conf(tmp_path, param="cpu", opt="none"), params)
    assert e._infinity.store.backend == "host"
    with pytest.raises(ValueError, match="train_batch"):
        e.forward(_batches(1)[0])
    with pytest.raises(ValueError, match="store"):
        e.params
    e.close()
    # layer streaming threads no per-layer window (JAX's refusal); a
    # model family streams
    with pytest.raises(ValueError, match="attn_windows"):
        deepspeed_tpu_torch.initialize(
            model=tt.make_model(dataclasses.replace(
                TCFG, attn_windows=(16,) * TCFG.num_layers)),
            config=_conf(tmp_path), device="cpu")
    fam = deepspeed_tpu_torch.initialize(
        model=tt.make_model(dataclasses.replace(
            TCFG, norm_type="layernorm")),
        config=_conf(tmp_path), device="cpu")[0]
    assert "ln1_bias" in dict(fam._infinity._template)
    assert np.isfinite(float(fam.train_batch(_batches(1)[0])["loss"]))
    fam.close()
    moe = dataclasses.replace(TCFG, num_experts=4, top_k=2)
    with pytest.raises((NotImplementedError, ValueError)):
        deepspeed_tpu_torch.initialize(model=tt.make_model(moe),
                                       config=_conf(tmp_path), device="cpu")
    conf = _conf(tmp_path)
    conf["optimizer"] = {"type": "sgd", "params": {"lr": 1e-3}}
    with pytest.raises(ValueError, match="Adam family"):
        _port(conf, params)
    comp = _port(dict(_conf(tmp_path), compression_training={
        "weight_quantization": {"shared_parameters": {"enabled": True}}}),
        params)
    assert comp._infinity.compression is comp._compression
    comp.close()
    with pytest.raises(NotImplementedError,
                       match="A11 .the extras JAX's executor ignores"):
        _port(dict(_conf(tmp_path), progressive_layer_drop={
            "enabled": True, "theta": 0.5, "gamma": 0.1}), params)
    c = Config.load(dict(_conf(tmp_path), mesh={"axes": {"fsdp": 2}}))
    assert c.mesh.axes == {"fsdp": 2}
    # close() deletes an executor's chunk directory
    assert not [f for f in os.listdir(tmp_path)
                if f.startswith("dstpu-infinity")]
