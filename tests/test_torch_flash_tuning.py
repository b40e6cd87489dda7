"""The port's tile table (ops/flash_tuning) against the JAX package's, and its
wiring into the port's flash attention, on the CPU.

The cases of ``tests/test_flash_tuning.py`` run on the port; both packages'
`lookup` read one table file over a grid of (S, D, dtype); unpinned blocks
resolve through `lookup`, and a pin outside the compiled set raises.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edl_tpu.ops import flash_tuning as jax_tuning
from edl_tpu_torch.ops import flash_tuning
from edl_tpu_torch.parallel.ring_attention import dense_attention

# the module (the package's attribute of that name is the function)
fa = importlib.import_module("edl_tpu_torch.ops.flash_attention")

DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16, "float32": torch.float32}


@pytest.fixture(autouse=True)
def fresh_cache():
    flash_tuning._load_table.cache_clear()
    jax_tuning._load_table.cache_clear()
    yield
    flash_tuning._load_table.cache_clear()
    jax_tuning._load_table.cache_clear()


def test_bucket_rounds_down_to_power_of_two():
    assert flash_tuning._bucket(128) == 128
    assert flash_tuning._bucket(1000) == 512
    assert flash_tuning._bucket(1024) == 1024
    assert flash_tuning._bucket(1500) == 1024


def test_lookup_default_when_table_absent(tmp_path):
    path = str(tmp_path / "missing.json")
    assert flash_tuning.lookup(2048, 64, torch.bfloat16, path=path) == \
        flash_tuning.DEFAULT_BLOCKS


def test_lookup_default_when_table_is_not_json(tmp_path):
    path = tmp_path / "bad.json"
    path.write_text("{not json")
    assert flash_tuning.lookup(2048, 64, "bfloat16", path=str(path)) == \
        flash_tuning.DEFAULT_BLOCKS


def test_save_then_lookup_roundtrip(tmp_path):
    path = str(tmp_path / "blocks.json")
    flash_tuning.save_table(
        {flash_tuning._key(2048, 64, "bfloat16"): (256, 512),
         flash_tuning._key(1024, 64, "any"): (256, 128)},
        {"note": "test"}, path=path,
    )
    # exact dtype match at the bucket, by torch dtype or by name
    assert flash_tuning.lookup(2048, 64, torch.bfloat16, path=path) == (256, 512)
    assert flash_tuning.lookup(2048, 64, "bfloat16", path=path) == (256, 512)
    # S between buckets falls to the lower bucket's dtype-agnostic entry
    assert flash_tuning.lookup(1500, 64, torch.bfloat16, path=path) == (256, 128)
    # f32 at 2048 misses the bf16 entry, falls through to 1024's "any"
    assert flash_tuning.lookup(2048, 64, torch.float32, path=path) == (256, 128)
    # unknown head dim: the default
    assert flash_tuning.lookup(2048, 128, torch.bfloat16, path=path) == \
        flash_tuning.DEFAULT_BLOCKS


def test_save_table_clears_the_cache(tmp_path):
    path = str(tmp_path / "blocks.json")
    flash_tuning.save_table({flash_tuning._key(1024, 64, "bfloat16"): (128, 64)}, {}, path=path)
    assert flash_tuning.lookup(1024, 64, "bfloat16", path=path) == (128, 64)
    flash_tuning.save_table({flash_tuning._key(1024, 64, "bfloat16"): (128, 128)}, {}, path=path)
    assert flash_tuning.lookup(1024, 64, "bfloat16", path=path) == (128, 128)


def test_dtype_names_are_the_jax_packages():
    for name, dtype in DTYPES.items():
        assert flash_tuning.dtype_name(dtype) == str(jnp.dtype(name)) == name


def test_one_table_file_reads_the_same_in_both_packages(tmp_path):
    """The port writes a table; both packages' lookup read it over a grid of
    (S, D, dtype) and give the same tile wherever the table answers (where
    it is silent, each gives its own default: the JAX kernel's 128 x 128,
    the port's forward tile)."""
    path = str(tmp_path / "blocks.json")
    flash_tuning.save_table({
        "1024,64,bfloat16": (128, 128), "4096,64,bfloat16": (128, 64),
        "2048,128,bfloat16": (128, 128), "8192,128,any": (128, 64),
        "512,64,float32": (64, 64), "256,40,any": (128, 64), "128,128,float16": (128, 64),
    }, {"note": "test"}, path=path)
    answered = 0
    for S in (100, 128, 200, 256, 300, 512, 1000, 1024, 1500, 2048, 3000, 4096, 8192, 9000):
        for D in (40, 64, 128):
            for name, dtype in DTYPES.items():
                got = flash_tuning.lookup(S, D, dtype, path=path)
                want = jax_tuning.lookup(S, D, np.dtype(jnp.dtype(name)), path=path)
                if got == flash_tuning.DEFAULT_BLOCKS and want == jax_tuning.DEFAULT_BLOCKS:
                    continue
                assert got == tuple(want), (S, D, name)
                answered += 1
    assert answered > 40


def test_unpinned_blocks_resolve_through_lookup(monkeypatch):
    table = {"1024,64,bfloat16": (128, 128), "1024,64,any": (128, 128),
             "2048,128,bfloat16": (128, 64)}
    monkeypatch.setattr(flash_tuning, "_load_table", lambda path=None: table)
    assert fa.resolve_blocks(1024, 64, torch.bfloat16) == (128, 128)
    assert fa.resolve_blocks(1500, 64, torch.bfloat16) == (128, 128)  # the lower bucket
    assert fa.resolve_blocks(2048, 128, torch.bfloat16) == (128, 64)
    assert fa.resolve_blocks(512, 64, torch.bfloat16) == flash_tuning.DEFAULT_BLOCKS
    # a tile the table names that is not compiled for the variant: its default
    assert fa.resolve_blocks(1024, 64, torch.float16) == (128, 64)
    assert fa.resolve_blocks(1024, 64, torch.float32) == (fa.TILE, fa.TILE)
    # and flash_attention hands the resolved keys a stage to the kernels
    seen = []
    apply = fa._Flash.apply
    monkeypatch.setattr(fa._Flash, "apply", lambda *args: seen.append(args[-1]) or apply(*args))
    x = torch.zeros((1, 1024, 1, 64), dtype=torch.bfloat16)
    fa.flash_attention(x, x, x)
    fa.flash_attention(x[:, :512], x[:, :512], x[:, :512])
    fa.flash_attention(x, x, x, block_q=128, block_k=64)
    assert seen == [128, 64, 64]


@pytest.mark.parametrize("dtype,blocks", [
    (torch.bfloat16, (256, 128)),
    (torch.bfloat16, (128, 256)),
    (torch.bfloat16, (64, 64)),
    (torch.float16, (128, 128)),
    (torch.float32, (128, 64)),
])
def test_a_pin_outside_the_compiled_set_raises(dtype, blocks):
    q = torch.zeros((1, 64, 1, 64), dtype=dtype)
    with pytest.raises(NotImplementedError, match="compiled for"):
        fa.flash_attention(q, q, q, block_q=blocks[0], block_k=blocks[1])


def test_a_pin_of_one_block_outside_the_compiled_set_raises():
    q = torch.zeros((1, 64, 1, 64), dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match=r"\[\(128, 64\), \(128, 128\)\]"):
        fa.flash_attention(q, q, q, block_q=256)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_kernel_correct_at_every_compiled_tile(dtype):
    """The counterpart of the JAX test with explicit non-default blocks: at
    every tile compiled for D 64, the same values as dense attention."""
    rng = np.random.default_rng(0)
    q, k, v = (torch.tensor(rng.standard_normal((1, 512, 2, 64)), dtype=DTYPES[dtype])
               for _ in range(3))
    want = dense_attention(q.float(), k.float(), v.float(), causal=True)
    for bq, bk in fa.compiled_blocks(64, DTYPES[dtype]):
        got = fa.flash_attention(q, k, v, causal=True, block_q=bq, block_k=bk)
        tol = 2e-3 if dtype == "float32" else 2e-2
        np.testing.assert_allclose(got.float().numpy(), want.numpy(), atol=tol, rtol=tol)
