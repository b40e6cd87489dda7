"""The port stands alone: no JAX, nothing of ``edl_tpu``, no quiet CPU fallback."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "edl_tpu_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "edl_tpu")

IMPORT_EVERYTHING = """
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "edl_tpu"):
    sys.modules[name] = None  # any import of them now raises ImportError
import edl_tpu_torch
names = ["chip_smoke"] + [m.name for m in pkgutil.walk_packages(
    edl_tpu_torch.__path__, "edl_tpu_torch.")]
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "edl_tpu")
                and sys.modules[m] is not None)
assert not leaked, leaked
print(len(names))
"""


def test_every_module_imports_without_jax_or_the_jax_package():
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    out = subprocess.run([sys.executable, "-c", IMPORT_EVERYTHING], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 131  # every module of the port so far


def _imported(tree: ast.AST):
    """Module names a source imports, including importlib.import_module("...")."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and getattr(node.func, "attr", getattr(node.func, "id", None))
              in ("import_module", "__import__")):
            yield node.args[0].value


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_neither_jax_nor_the_jax_package(path):
    bad = [m for m in _imported(ast.parse(path.read_text()))
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_entry_points_raise_without_cuda_unless_the_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device: the default device is real")
    from edl_tpu_torch.models import transformer
    from edl_tpu_torch.runtime import Trainer

    model = transformer.make_model(vocab_size=64, d_model=32, n_layers=1,
                                   n_heads=4, d_ff=64, seq_len=16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(model)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model.build()
    Trainer(model, device="cpu").init_state()


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["float32", "head_dim_128", "odd_stride",
                                  "stride_not_16B"])
def test_kernel_wrapper_raises_on_cuda_requests_it_cannot_serve(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from edl_tpu_torch.ops import flash_attention

    dtype = torch.float32 if case == "float32" else torch.bfloat16
    D = 128 if case == "head_dim_128" else 64
    q = torch.zeros((1, 16, 2, D), dtype=dtype, device="cuda")
    if case == "odd_stride":
        q = torch.zeros((1, 16, 2, D + 1), dtype=dtype, device="cuda")[..., 1:]
    if case == "stride_not_16B":  # head stride 68 bf16 = 136 bytes
        q = torch.zeros((1, 16, 2, D + 4), dtype=dtype, device="cuda")[..., :D]
    with pytest.raises((NotImplementedError, ValueError)):
        flash_attention(q, q, q)
