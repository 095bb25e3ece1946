"""The port stands alone: no file of deepspeed_tpu_torch/ or chip_smoke.py
imports jax or the JAX package, the attention functions are never handed
to a library, entry points never carry on silently on the CPU, and the
ctypes bindings match the CUDA sources' C signatures."""

import ast
import ctypes
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch.ops import _build

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "deepspeed_tpu_torch"
PORT_FILES = sorted(PORT.rglob("*.py"))
FORBIDDEN = ("jax", "jaxlib", "deepspeed_tpu")


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _forbidden(module: str) -> bool:
    # "deepspeed_tpu_torch" shares a prefix with "deepspeed_tpu": compare
    # whole dotted components
    return module.split(".")[0] in FORBIDDEN


def test_forbidden_prefix_rule():
    assert _forbidden("jax.numpy") and _forbidden("deepspeed_tpu.models")
    assert not _forbidden("deepspeed_tpu_torch.models")


@pytest.mark.parametrize("path", PORT_FILES + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imports(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_port_never_calls_a_library_attention():
    """SDPA, cuDNN attention and torch.compile appear nowhere in the port
    (chip_smoke.py times SDPA as a yardstick only)."""
    for path in PORT_FILES:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Attribute):
                assert node.attr not in ("scaled_dot_product_attention",
                                         "compile", "cudnn"), \
                    f"{path.relative_to(ROOT)} uses .{node.attr}"


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = deepspeed_tpu_torch.make_model(deepspeed_tpu_torch.llama_config(
        "tiny", num_layers=1, vocab_size=64))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        deepspeed_tpu_torch.init_serving(model, serving=dict(max_seqs=1))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        deepspeed_tpu_torch.init_inference(model)


def test_wrappers_refuse_other_devices():
    """Only CPU tensors take the plain version; anything else that is not
    CUDA raises instead of falling back."""
    from deepspeed_tpu_torch.ops.flash_attention import flash_attention
    q = torch.empty((1, 64, 2, 64), device="meta")
    with pytest.raises(ValueError, match="runs on cuda"):
        flash_attention(q, q, q)


_CTYPE = {"void*": ctypes.c_void_p, "int": ctypes.c_int,
          "float": ctypes.c_float}


@pytest.mark.parametrize("kernel", list(_build.KERNELS.values()),
                         ids=lambda k: k.name)
def test_ctypes_argtypes_match_c_signature(kernel):
    """Every pointer and the stream go as c_void_p (a c_int would cut a
    64-bit pointer), every int as c_int, every float as c_float."""
    src = kernel.source.read_text()
    m = re.search(r'extern "C" int (\w+)\(([^)]*)\)', src)
    assert m and m.group(1) == kernel.name
    params = [re.sub(r"\bconst\b|\s", "", p).split("*")[0] + "*"
              if "*" in p else p.split()[0] for p in m.group(2).split(",")]
    assert [_CTYPE[p] for p in params] == kernel.argtypes


def test_nvcc_command_targets_sm90a(monkeypatch):
    nvcc = "/usr/local/cuda/bin/nvcc"
    monkeypatch.setattr(_build.shutil, "which", lambda _: nvcc)
    cmd = _build.nvcc_command(_build.FLASH_FWD, Path("out.so"))
    assert cmd[0] == nvcc
    assert "arch=compute_90a,code=sm_90a" in cmd and "-shared" in cmd
    assert cmd[-1] == str(_build.FLASH_FWD.source)
    assert _build.FLASH_FWD.library_path().parent == _build.BUILD_DIR


def test_chip_smoke_alone_fails(tmp_path):
    """In a directory with nothing else of the repo (or without CUDA) the
    script exits non-zero and prints no result."""
    (tmp_path / "chip_smoke.py").write_text(
        (ROOT / "chip_smoke.py").read_text())
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
