"""The port's wire codec against the JAX package's, on the CPU.

The same numpy batches (each model's ``synthetic_batch`` from one seed)
go through both codecs. Tolerance: none. The inferred encodings and the
JSON spec are equal as strings; the encoded bytes are equal (bf16 compared
as its uint16 bits: the port's ``torch`` cast and ``ml_dtypes``' both round
to nearest even, and the test batch adds ties, infinities, NaN and
subnormals to the CTR features); the decoded batches are equal bit for bit.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from edl_tpu.models import ctr as jax_ctr
from edl_tpu.models import fit_a_line as jax_fit
from edl_tpu.models import transformer as jax_tf
from edl_tpu.runtime.wire import WireCodec as JaxCodec
from edl_tpu.runtime.wire import WireOverflowError as JaxOverflow
from edl_tpu_torch.models import ctr, fit_a_line, transformer
from edl_tpu_torch.runtime.wire import WireCodec, WireOverflowError

LM_KW = dict(vocab_size=300, d_model=16, n_layers=1, n_heads=2, d_ff=32, seq_len=16)


def _ctr_batch(rng):
    batch = ctr.MODEL.synthetic_batch(rng, 64)
    # bf16 ties (a 1 in the 17th bit only), its neighbours, specials
    edge = np.array([1 + 2**-8, 1 + 3 * 2**-8, -(1 + 2**-8), 1 + 2**-8 + 2**-20,
                     np.inf, -np.inf, np.nan, -np.nan, 1e-40, -1e-45, 3.4e38, 0.0, -0.0,
                     65504.0], np.float32)
    batch["dense"].reshape(-1)[:len(edge)] = edge
    return batch


BATCHES = {
    "ctr": _ctr_batch,
    "fit_a_line": lambda rng: fit_a_line.MODEL.synthetic_batch(rng, 32),
    "lm": lambda rng: transformer.make_model(**LM_KW).synthetic_batch(rng, 4),
}
LABELS = {"ctr": ctr.MODEL.label_keys, "fit_a_line": fit_a_line.MODEL.label_keys,
          "lm": ("targets",)}


def _bits(a) -> np.ndarray:
    """An encoded value as comparable numpy: bf16 as its uint16 bits."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().view(np.uint16)
        return a.numpy()
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype == ml_dtypes.bfloat16 else a


@pytest.mark.parametrize("name", sorted(BATCHES))
def test_infer_spec_encode_and_decode_equal_the_jax_codec(name):
    batch = BATCHES[name](np.random.default_rng(0))
    codec = WireCodec.infer(batch, no_lossy_keys=LABELS[name])
    jcodec = JaxCodec.infer(batch, no_lossy_keys=LABELS[name])
    assert codec.to_spec() == jcodec.to_spec()
    assert {k: v.encoding for k, v in codec.keys.items()} == {
        k: v.encoding for k, v in jcodec.keys.items()}

    enc, jenc = codec.encode(batch), jcodec.encode(batch)
    assert set(enc) == set(jenc)
    for k in enc:
        assert enc[k].device.type == "cpu"
        np.testing.assert_array_equal(_bits(enc[k]), _bits(jenc[k]), err_msg=k)
        assert _bits(enc[k]).dtype == _bits(jenc[k]).dtype
    assert codec.wire_bytes(batch) == jcodec.wire_bytes(batch)

    dec = codec.decode(enc)
    jdec = jcodec.decode({k: jnp.asarray(v) for k, v in jenc.items()})
    for k in dec:
        got, want = dec[k].numpy(), np.asarray(jdec[k])
        assert got.dtype == want.dtype == batch[k].dtype, k
        np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8), err_msg=k)


@pytest.mark.parametrize("name,jax_model", [
    ("ctr", jax_ctr.MODEL), ("fit_a_line", jax_fit.MODEL),
    ("lm", jax_tf.make_model(**LM_KW))])
def test_the_batches_are_the_jax_packages(name, jax_model):
    """The codecs above see the JAX package's own batches: the port's
    ``synthetic_batch`` gives the same arrays for the same generator."""
    batch = BATCHES[name](np.random.default_rng(0))
    want = jax_model.synthetic_batch(np.random.default_rng(0),
                                     len(next(iter(batch.values()))))
    if name == "ctr":
        want["dense"].reshape(-1)[:14] = batch["dense"].reshape(-1)[:14]  # the edges
    assert set(batch) == set(want)
    for k in batch:
        np.testing.assert_array_equal(batch[k], want[k], err_msg=k)


def test_ctr_encodings_and_bytes():
    batch = ctr.MODEL.synthetic_batch(np.random.default_rng(0), 8192)
    codec = WireCodec.infer(batch, no_lossy_keys=ctr.MODEL.label_keys)
    assert {k: v.encoding for k, v in codec.keys.items()} == {
        "dense": "bf16", "sparse": "u24", "label": "u8"}
    raw = sum(v.nbytes for v in batch.values())
    assert raw == 1_310_720 and codec.wire_bytes(batch) == 860_160
    assert codec.encode(batch)["sparse"].shape == (8192, 26, 3)


@pytest.mark.parametrize("direction", ["port_spec_in_jax", "jax_spec_in_port"])
def test_spec_crosses_between_packages(direction):
    batch = BATCHES["ctr"](np.random.default_rng(0))
    if direction == "port_spec_in_jax":
        spec = WireCodec.infer(batch, no_lossy_keys=("label",)).apply_floor(
            {"label": "u24"}).to_spec()
        twin = JaxCodec.from_spec(spec)
    else:
        spec = JaxCodec.infer(batch, no_lossy_keys=("label",)).apply_floor(
            {"label": "u24"}).to_spec()
        twin = WireCodec.from_spec(spec)
    assert twin.to_spec() == spec
    assert twin.keys["label"].encoding == "u24"
    assert WireCodec.from_spec(spec).wire_bytes(batch) == JaxCodec.from_spec(
        spec).wire_bytes(batch)


def test_overflow_and_widening_match_the_jax_codec():
    example = {"ids": np.array([0, 100], np.int32)}
    codec, jcodec = WireCodec.infer(example), JaxCodec.infer(example)
    over = {"ids": np.array([0, 300], np.int32)}
    with pytest.raises(WireOverflowError) as e:
        codec.encode(over)
    with pytest.raises(JaxOverflow):
        jcodec.encode(over)
    assert e.value.key == "ids"
    wide, jwide = codec.widen("ids"), jcodec.widen("ids")
    assert wide.to_spec() == jwide.to_spec()
    np.testing.assert_array_equal(wide.encode(over)["ids"].numpy(), jwide.encode(over)["ids"])
    huge = {"ids": np.array([0, 1 << 24], np.int32)}
    with pytest.raises(WireOverflowError):
        wide.encode(huge)
    raw = wide.widen("ids")
    assert raw.to_spec() == jwide.widen("ids").to_spec()
    assert torch.equal(raw.decode(raw.encode(huge))["ids"], torch.from_numpy(huge["ids"]))
    with pytest.raises(KeyError):
        raw.widen("ids")


def test_u24_boundaries_and_large_ints_raw():
    batch = {"ids": np.array([0, (1 << 24) - 1, 12345678, 65536, 255], np.int64)}
    codec = WireCodec.infer(batch)
    assert codec.keys["ids"].encoding == "u24"
    out = codec.decode(codec.encode(batch))["ids"]
    assert out.dtype == torch.int64
    np.testing.assert_array_equal(out.numpy(), batch["ids"])
    assert WireCodec.infer({"ids": np.array([0, 1 << 25])}).keys["ids"].encoding == "raw"
    assert WireCodec.infer({"ids": np.array([-1, 3])}).keys["ids"].encoding == "raw"


def test_apply_floor_widens_ints_only():
    codec = WireCodec.infer({"ids": np.array([1, 2, 3], np.int32),
                             "x": np.zeros((3,), np.float32)})
    jcodec = JaxCodec.infer({"ids": np.array([1, 2, 3], np.int32),
                             "x": np.zeros((3,), np.float32)})
    floor = {"ids": "u24", "x": "raw"}
    assert codec.apply_floor(floor).to_spec() == jcodec.apply_floor(floor).to_spec()
    assert codec.apply_floor(floor).keys["x"].encoding == "bf16"
    assert codec.apply_floor({"ids": "u8"}).keys["ids"].encoding == "u8"


def test_is_encoded_on_tensors_and_arrays():
    batch = BATCHES["ctr"](np.random.default_rng(0))
    codec = WireCodec.infer(batch)
    enc = codec.encode(batch)
    assert codec.is_encoded(enc)
    assert not codec.is_encoded({k: torch.from_numpy(v) for k, v in batch.items()})
    assert not codec.is_encoded(batch)
    assert codec.is_encoded(JaxCodec.infer(batch).encode(batch))  # ml_dtypes bf16
    ids_only = WireCodec.infer({"sparse": batch["sparse"]})
    assert ids_only.is_encoded({"sparse": enc["sparse"]})
    assert ids_only.is_encoded({"sparse": enc["sparse"].numpy()})
    assert not ids_only.is_encoded({"sparse": torch.from_numpy(batch["sparse"])})


def test_no_lossy_float_keys_stay_raw_and_exact():
    example = {"x": np.random.default_rng(0).standard_normal((8, 13)).astype(np.float32),
               "y": np.random.default_rng(1).standard_normal((8, 1)).astype(np.float32),
               "label": np.array([0, 1] * 4, dtype=np.int64)}
    codec = WireCodec.infer(example, no_lossy_keys=("y", "label"))
    assert [codec.keys[k].encoding for k in ("x", "y", "label")] == ["bf16", "raw", "u8"]
    np.testing.assert_array_equal(codec.encode(example)["y"].numpy(), example["y"])
    assert JaxCodec.infer(example, no_lossy_keys=("y", "label")).to_spec() == codec.to_spec()


def test_kv_codec_channel_agrees_across_two_ranks_and_an_overflow_raises_the_floor(tmp_path):
    """CTR with wire transport on two gloo ranks (`torch_dp_worker`), the
    codec agreed through a `KVCodecChannel` over the process group's store:
    rank 0 infers and publishes, rank 1 fetches, and both hold the same
    spec, which the JAX codec reads back unchanged (tolerance: none, equal
    strings); both ranks step with it and report the same losses. Then a
    batch whose u8 label overflows on rank 1 alone makes rank 1 raise the
    label's floor to u24 and ask for the gang restart
    (`WireRestartRequired`), while rank 0 places its batch; the next
    epoch's channel reads the raised floor on both ranks."""
    from torch_dp_worker import spawn_ranks

    model = ctr.make_model(sparse_dim=1000)
    params = model.build(device="cpu", generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    case = dict(model="ctr", model_kwargs=dict(sparse_dim=1000),
                config=dict(optimizer="adagrad", learning_rate=0.05, wire_transport=True),
                axes={"data": 2}, params=params.state_dict(),
                batches=[model.synthetic_batch(rng, 32) for _ in range(2)])
    results = [r[0] for r in spawn_ranks(tmp_path, 2, [("wire", case)])]
    spec = results[0]["spec"]
    assert results[1]["spec"] == spec
    assert JaxCodec.from_spec(spec).to_spec() == spec
    assert WireCodec.from_spec(spec).keys["label"].encoding == "u8"
    assert results[0]["losses"] == results[1]["losses"]
    assert all(np.isfinite(results[0]["losses"]))
    assert [r["restart"] for r in results] == [None, "label"]
    assert [r["floor"] for r in results] == [{"label": "u24"}] * 2
