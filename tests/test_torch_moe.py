"""The port's mixture-of-experts LM against the JAX package's, on the CPU.

Sizes are `tests/test_moe.py`'s: vocab 64, d_model 32, 2 layers, 8 heads,
d_ff 64, seq 16, 4 experts. JAX params are made by the JAX package on a
one-device mesh and carried across with `params_from_jax`; activations,
cotangents and batches are made with numpy from seeds.

The MoE FFN is held per function on the same bf16 ``h`` and block params,
so both sides route the same tokens (a routing flip changes a token's
output by O(1), which no tolerance should absorb):

- slot assignment (expert, slot, kept) equal to the JAX package's;
- the port's index form (`_moe_ffn`) and its einsum form
  (`_moe_ffn_reference`) against the JAX ``_moe_ffn``: output within a
  relative norm error of 1e-2 (measured: at most 3.4e-3, bf16 ulps of the
  expert matmuls, which XLA and PyTorch round at their own places), aux
  within 1e-6 (measured: at most 1.2e-7), and the ``jax.vjp``/autograd
  gradients of ``h`` and of every expert leaf within 5e-2 (measured: at
  most 8.1e-3), at top-1 and top-2 and at a no-drop (8.0) and a dropping
  (0.25) capacity factor;
- index form against einsum form: output and aux equal bit for bit, and
  every gradient within 1e-2 (measured: 0, equal on every case).

The whole MoE LM against the JAX model through `params_from_jax`, at the
default capacity factor 1.25: loss within rel 2e-2 and each gradient leaf
within a relative norm error of 5e-2, `tests/test_torch_transformer.py`'s
tolerances (measured: loss 1.6e-6 at top-1 with aux 0.01 and 1.3e-5 at
top-2; gradients 1.3e-2 and 1.8e-2). Here the router sees each side's own
``h``, which differ by bf16 ulps (2^-8 of a value) after the attention, so
a token whose deciding router probabilities nearly tie could change
expert. On this batch the port measured the smallest such gap at 4.5e-4
(top-1: first against second choice; layer 0) and at 2.1e-5 (top-2:
second against third choice; layer 0); no token changed expert.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from edl_tpu.models import transformer as jax_tf
from edl_tpu.parallel import MeshSpec, build_mesh
from edl_tpu.runtime import export as jax_export
from edl_tpu.runtime.export import _serving_mesh
from edl_tpu_torch.models import transformer as torch_tf
from edl_tpu_torch.models.convert import (MOE_BLOCK_PARAMS, block_params, params_from_jax,
                                          params_to_jax)
from edl_tpu_torch.parallel.mesh import Mesh
from edl_tpu_torch.runtime import (Trainer, TrainerConfig, load_inference_model,
                                   read_artifact, save_inference_model)

CFG = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=8, d_ff=64, seq_len=16,
           moe_experts=4, moe_capacity_factor=8.0)
OUT_REL = 1e-2
AUX_ABS = 1e-6
GRAD_REL = 5e-2
FORMS_GRAD_REL = 1e-2
LOSS_RTOL = 2e-2
GRAD_REL_NORM = 5e-2


def _mesh():
    return build_mesh(MeshSpec({"data": 1}), jax.devices()[:1])


def _rel(got, want) -> float:
    got, want = (torch.as_tensor(np.array(x, np.float32)) if not isinstance(x, torch.Tensor)
                 else x.float() for x in (got, want))
    return ((got - want).norm() / want.norm()).item()


def jax_params(seed: int = 0, **overrides):
    cfg = jax_tf.TransformerConfig(**{**CFG, **overrides})
    return cfg, jax_tf.make_model(cfg).init(jax.random.PRNGKey(seed), _mesh())


def port_module(params, **overrides) -> torch_tf.TransformerLM:
    module = torch_tf.TransformerLM(torch_tf.TransformerConfig(**{**CFG, **overrides}),
                                    device="cpu")
    module.load_state_dict(params_from_jax(jax.device_get(params)))
    return module


def layer_inputs(seed: int, batch: int = 4):
    """A bf16 ``h`` (B, S, D), the f32 cotangent of the FFN's output and
    the aux's, from numpy."""
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((batch, CFG["seq_len"], CFG["d_model"])).astype(np.float32)
    h = np.array(jnp.asarray(h, jnp.bfloat16).astype(jnp.float32))
    ct = rng.standard_normal(h.shape).astype(np.float32)
    return h, ct, np.float32(0.7)


def jax_slots(cfg, h, router):
    """The JAX package's routing lines (`edl_tpu/models/transformer.py:
    333-359`) on ``h``: per choice row, (expert, slot, kept)."""
    E, k = cfg.moe_experts, cfg.moe_top_k
    tok = jnp.asarray(h, jnp.bfloat16).reshape(-1, cfg.d_model)
    T = tok.shape[0]
    cap = max(1, int(np.ceil(k * T / E * cfg.moe_capacity_factor)))
    probs = jax.nn.softmax(jnp.einsum("td,de->te", tok.astype(jnp.float32), router), -1)
    remaining, onehots = probs, []
    for _ in range(k):
        oh = jax.nn.one_hot(remaining.argmax(axis=-1), E, dtype=jnp.int32)
        onehots.append(oh)
        remaining = remaining * (1 - oh)
    oh_all = jnp.concatenate(onehots, axis=0)
    pos = jnp.cumsum(oh_all, axis=0) * oh_all - 1
    slot = np.asarray(pos.max(axis=-1))
    return np.asarray(oh_all.argmax(axis=-1)), slot, slot < cap


def run_port(form, cfg, blk, h, ct, ct_aux):
    """The port's FFN ``form`` on h: (out, aux, {leaf: grad}) after the
    backward of sum(out * ct) + aux * ct_aux."""
    blk.zero_grad()
    ht = torch.from_numpy(h).to(torch.bfloat16).requires_grad_()
    out, aux = form(cfg, ht, blk)
    ((out * torch.from_numpy(ct)).sum() + aux * float(ct_aux)).backward()
    grads = {"h": ht.grad, **{n: getattr(blk, n).grad for n in
                              ("router", "w_up", "b_up", "w_down", "b_down")}}
    return out.detach(), aux.detach(), grads


FORMS = {"index": torch_tf._moe_ffn, "einsum": torch_tf._moe_ffn_reference}
CASES = [(k, cf) for k in (1, 2) for cf in (8.0, 0.25)]
IDS = [f"top{k}-cf{cf}" for k, cf in CASES]


@pytest.mark.parametrize("k,cf", CASES, ids=IDS)
def test_moe_ffn_matches_the_jax_moe_ffn(k, cf):
    jcfg, params = jax_params(moe_top_k=k, moe_capacity_factor=cf)
    bp = jax.tree_util.tree_map(lambda a: a[0], params["blocks"])
    h, ct, ct_aux = layer_inputs(seed=10 + k)
    (jout, jaux), vjp = jax.vjp(lambda hh, p: jax_tf._moe_ffn(jcfg, _mesh(), hh, p),
                                jnp.asarray(h, jnp.bfloat16), bp)
    jgh, jgp = vjp((jnp.asarray(ct), jnp.asarray(ct_aux)))
    want = {"h": jgh, **{n: jgp[n] for n in ("router", "w_up", "b_up", "w_down", "b_down")}}

    module = port_module(params, moe_top_k=k, moe_capacity_factor=cf)
    tcfg, blk = module.cfg, module.blocks[0]
    T = h.shape[0] * h.shape[1]
    route = torch_tf._moe_route(tcfg, torch.from_numpy(h).to(torch.bfloat16).reshape(T, -1),
                                blk.router, torch_tf._moe_capacity(tcfg, T))
    expert, slot, kept = jax_slots(jcfg, h, bp["router"])
    np.testing.assert_array_equal(route.expert.numpy(), expert)
    np.testing.assert_array_equal(route.slot.numpy(), slot)
    np.testing.assert_array_equal(route.keep.numpy(), kept)
    if cf < 1:
        assert not kept.all()  # the dropping case drops
    for name, form in FORMS.items():
        out, aux, grads = run_port(form, tcfg, blk, h, ct, ct_aux)
        assert out.dtype == torch.float32 and out.shape == h.shape
        assert _rel(out, jout) <= OUT_REL, (name, _rel(out, jout))
        assert abs(aux.item() - float(jaux)) <= AUX_ABS, (name, aux.item(), float(jaux))
        for leaf, g in grads.items():
            assert _rel(g, want[leaf]) <= GRAD_REL, (name, leaf, _rel(g, want[leaf]))


@pytest.mark.parametrize("k,cf", CASES + [(1, 1.0), (2, 1.0)],
                         ids=IDS + ["top1-cf1.0", "top2-cf1.0"])
def test_index_form_equals_einsum_form_bit_for_bit(k, cf):
    _, params = jax_params(seed=3, moe_top_k=k, moe_capacity_factor=cf)
    module = port_module(params, moe_top_k=k, moe_capacity_factor=cf)
    h, ct, ct_aux = layer_inputs(seed=20 + k, batch=8)
    got = run_port(torch_tf._moe_ffn, module.cfg, module.blocks[1], h, ct, ct_aux)
    want = run_port(torch_tf._moe_ffn_reference, module.cfg, module.blocks[1], h, ct, ct_aux)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    for leaf in got[2]:
        assert _rel(got[2][leaf], want[2][leaf]) <= FORMS_GRAD_REL, leaf


class _Shapes(TorchDispatchMode):
    """Records the element count of every tensor an op returns."""

    def __init__(self):
        super().__init__()
        self.numels = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.numels += [t.numel() for t in jax.tree_util.tree_leaves(out)
                        if isinstance(t, torch.Tensor)]
        return out


@pytest.mark.parametrize("k", [1, 2])
def test_index_form_makes_no_one_hot_dispatch(k):
    """Forward and backward of the index form make no tensor as large as the
    (k*T, E, C) one-hot (at T = 128 larger than every other intermediate:
    the experts' (E, C, F) is smaller as F < k*T); the einsum form does,
    which shows the check sees one."""
    _, params = jax_params(moe_top_k=k)
    module = port_module(params, moe_top_k=k)
    h, ct, ct_aux = layer_inputs(seed=5, batch=8)
    T = h.shape[0] * h.shape[1]
    one_hot = k * T * CFG["moe_experts"] * torch_tf._moe_capacity(module.cfg, T)
    for form, makes_it in ((torch_tf._moe_ffn, False), (torch_tf._moe_ffn_reference, True)):
        with _Shapes() as seen:
            run_port(form, module.cfg, module.blocks[0], h, ct, ct_aux)
        assert (max(seen.numels) >= one_hot) == makes_it, (form.__name__, max(seen.numels))


def test_empty_slots_and_unused_experts_get_no_gradient():
    """At a capacity that leaves most slots empty, the empty slots still run
    the experts' biases, but no gradient comes back from them: an expert that
    no token picks gets zero gradients, and a used expert's b_down gradient
    is the sum of its kept choices' gate times cotangent."""
    _, params = jax_params(moe_top_k=2)
    module = port_module(params, moe_top_k=2)
    cfg, blk = module.cfg, module.blocks[0]
    with torch.no_grad():
        blk.router[:, 3] = -1e4  # on h >= 0, expert 3 is in no token's top two
        blk.b_up.normal_(generator=torch.Generator().manual_seed(0))
        blk.b_down.normal_(generator=torch.Generator().manual_seed(1))
    h, ct, _ = layer_inputs(seed=7)
    h = np.abs(h)
    T = h.shape[0] * h.shape[1]
    route = torch_tf._moe_route(cfg, torch.from_numpy(h).to(torch.bfloat16).reshape(T, -1),
                                blk.router, torch_tf._moe_capacity(cfg, T))
    assert route.keep.all() and not (route.expert == 3).any()
    _, _, grads = run_port(torch_tf._moe_ffn, cfg, blk, h, ct, 0.0)
    for leaf in ("w_up", "b_up", "w_down", "b_down"):
        assert torch.count_nonzero(grads[leaf][3]) == 0, leaf
    g = torch.from_numpy(ct).to(torch.bfloat16).float().reshape(T, -1)
    gate = route.gate.to(torch.bfloat16).float().reshape(-1)
    want = torch.zeros_like(blk.b_down).index_add_(0, route.expert, gate[:, None] * g.repeat(2, 1))
    assert _rel(grads["b_down"][:3], want[:3]) <= 1e-2


@pytest.mark.parametrize("k,aux", [(1, 0.01), (2, 0.0)], ids=["top1-aux0.01", "top2"])
def test_moe_lm_loss_and_grads_match_jax(k, aux):
    over = dict(moe_top_k=k, moe_aux_weight=aux, moe_capacity_factor=1.25)
    jcfg, params = jax_params(**over)
    jm = jax_tf.make_model(jcfg)
    batch = jm.synthetic_batch(np.random.default_rng(0), 4)
    jl, jg = jax.jit(jax.value_and_grad(lambda p, b: jm.loss_fn(p, b, _mesh())))(
        params, {key: jnp.asarray(v) for key, v in batch.items()})
    module = port_module(params, **over)
    loss = module({key: torch.from_numpy(v) for key, v in batch.items()})
    loss.backward()
    assert loss.item() == pytest.approx(float(jl), rel=LOSS_RTOL)
    want = params_from_jax(jax.device_get(jg))
    for name, p in module.named_parameters():
        assert _rel(p.grad, want[name]) <= GRAD_REL_NORM, (name, _rel(p.grad, want[name]))


def test_aux_weight_adds_the_per_layer_mean_of_the_aux():
    _, params = jax_params()
    batch = {k: torch.from_numpy(v) for k, v in torch_tf.synthetic_batch(
        torch_tf.TransformerConfig(**CFG), np.random.default_rng(1), 4).items()}
    auxes = []
    plain = port_module(params)
    for blk in plain.blocks:
        blk.register_forward_hook(lambda mod, args, out: auxes.append(out[1]))
    base = plain(batch)
    weighted = port_module(params, moe_aux_weight=0.05)(batch)
    want = base + 0.05 / CFG["n_layers"] * (auxes[0] + auxes[1])
    assert all(a.item() > 0 for a in auxes)
    assert torch.equal(weighted, want)


# -- mirrors of tests/test_moe.py ----------------------------------------------


def test_single_expert_equals_dense_ffn():
    """E = 1 with no drops is the dense FFN (gate = softmax over one logit =
    1): the same loss with the expert's weights copied into the dense slots."""
    _, params = jax_params(moe_experts=1)
    moe = port_module(params, moe_experts=1)
    dense = torch_tf.TransformerLM(torch_tf.TransformerConfig(**{**CFG, "moe_experts": 0}),
                                   device="cpu")
    state = {k: v for k, v in moe.state_dict().items()
             if not k.endswith(("router", "w_up", "b_up", "w_down", "b_down"))}
    for i in range(CFG["n_layers"]):
        for src, dst in (("w_up", "win"), ("b_up", "bin"), ("w_down", "wout"),
                         ("b_down", "bout")):
            state[f"blocks.{i}.{dst}"] = moe.state_dict()[f"blocks.{i}.{src}"][0]
    dense.load_state_dict(state)
    batch = {k: torch.from_numpy(v) for k, v in torch_tf.synthetic_batch(
        moe.cfg, np.random.default_rng(0), 4).items()}
    assert moe(batch).item() == pytest.approx(dense(batch).item(), rel=1e-3)


def test_top2_with_all_experts_equals_soft_mixture():
    """E = 2, k = 2, no drops: every token visits both experts and the
    renormalized gates are the softmax probs: the dense soft mixture."""
    _, params = jax_params(moe_experts=2, moe_top_k=2, moe_capacity_factor=4.0)
    module = port_module(params, moe_experts=2, moe_top_k=2, moe_capacity_factor=4.0)
    blk = module.blocks[0]
    rng = np.random.default_rng(3)
    h = torch.from_numpy(rng.standard_normal((2, 16, CFG["d_model"])).astype(np.float32)
                         ).to(torch.bfloat16)
    with torch.no_grad():
        got, _ = torch_tf._moe_ffn(module.cfg, h, blk)
        tok = h.reshape(-1, CFG["d_model"])
        probs = torch.softmax(tok.float() @ blk.router, -1)

        def expert(e):
            up = tok @ blk.w_up[e].to(torch.bfloat16) + blk.b_up[e].to(torch.bfloat16)
            return (torch_tf._gelu(up) @ blk.w_down[e].to(torch.bfloat16)
                    + blk.b_down[e].to(torch.bfloat16))

        want = sum(probs[:, e:e + 1].to(torch.bfloat16) * expert(e) for e in range(2))
    np.testing.assert_allclose(got.numpy(), want.float().reshape(got.shape).numpy(),
                               rtol=5e-2, atol=5e-2)


def test_capacity_drops_are_total_not_corrupting():
    """A tiny capacity drops tokens (their FFN output is zero; the residual
    carries them): loss and gradients stay finite."""
    _, params = jax_params(moe_capacity_factor=0.25)
    module = port_module(params, moe_capacity_factor=0.25)
    batch = {k: torch.from_numpy(v) for k, v in torch_tf.synthetic_batch(
        module.cfg, np.random.default_rng(0), 4).items()}
    loss = module(batch)
    loss.backward()
    assert np.isfinite(loss.item())
    assert all(torch.isfinite(p.grad).all() for p in module.parameters())


def test_moe_flops_accounting():
    cfg = torch_tf.TransformerConfig(**CFG)
    dense = torch_tf.make_model(dataclasses.replace(cfg, moe_experts=0))
    moe = torch_tf.make_model(cfg)
    # top-1 routing: only the router matmul is extra
    extra = 3.0 * 2 * CFG["d_model"] * CFG["moe_experts"] * CFG["n_layers"] * CFG["seq_len"] * 4
    assert moe.flops_per_step(4) - dense.flops_per_step(4) == pytest.approx(extra)
    jcfg = jax_tf.TransformerConfig(**{**CFG, "moe_top_k": 2})
    assert torch_tf._flops_per_step(dataclasses.replace(cfg, moe_top_k=2), 8) == \
        jax_tf._flops_per_step(jcfg, 8)


@pytest.mark.parametrize("top_k", [5, 0])
def test_top_k_out_of_range_raises(top_k):
    with pytest.raises(ValueError, match="moe_top_k"):
        torch_tf.make_model(torch_tf.TransformerConfig(**{**CFG, "moe_top_k": top_k}))
    with pytest.raises(ValueError, match="moe_top_k"):
        jax_tf.make_model(jax_tf.TransformerConfig(**{**CFG, "moe_top_k": top_k})).init(
            jax.random.PRNGKey(0), _mesh())


def test_indivisible_experts_and_an_expert_axis_raise():
    cfg = torch_tf.TransformerConfig(**{**CFG, "moe_experts": 3})
    expert_axis = Mesh(["expert"], [2], 0, 2)
    with pytest.raises(ValueError, match="moe_experts"):
        torch_tf.TransformerLM(cfg, device="cpu", mesh=expert_axis)
    # an expert axis runs on a mesh over a process group
    # (tests/test_torch_model_parallel.py); without one, the module raises
    with pytest.raises(ValueError, match="need a mesh over a process group"):
        torch_tf.TransformerLM(torch_tf.TransformerConfig(**CFG), device="cpu",
                               mesh=expert_axis)


# -- remat, the Trainer ---------------------------------------------------------


@pytest.mark.parametrize("k", [1, 2])
def test_remat_gives_the_same_loss_and_grads(k):
    _, params = jax_params(seed=2, moe_top_k=k, moe_aux_weight=0.01)
    batch = {key: torch.from_numpy(v) for key, v in torch_tf.synthetic_batch(
        torch_tf.TransformerConfig(**CFG), np.random.default_rng(1), 4).items()}
    results = []
    for remat in (False, True):
        module = port_module(params, moe_top_k=k, moe_aux_weight=0.01, remat=remat)
        loss = module(batch)
        loss.backward()
        results.append((loss.detach(), {n: p.grad for n, p in module.named_parameters()}))
    (l0, g0), (l1, g1) = results
    assert torch.equal(l0, l1)
    for name in g0:
        assert torch.equal(g0[name], g1[name]), name


@pytest.mark.parametrize("k", [1, 2])
def test_trainer_steps_the_moe_lm_and_its_loss_falls(k):
    model = torch_tf.make_model(torch_tf.TransformerConfig(
        **{**CFG, "moe_top_k": k, "moe_aux_weight": 0.01, "moe_capacity_factor": 1.25}))
    trainer = Trainer(model, device="cpu", config=TrainerConfig(
        optimizer="adam", learning_rate=1e-3, seed=0))
    state = trainer.init_state()
    batch = trainer.place_batch(model.synthetic_batch(np.random.default_rng(1), 8))
    losses = []
    for _ in range(8):
        state, loss = trainer.train_step(state, batch)
        losses.append(float(loss))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses


# -- params and artifacts across -------------------------------------------------


def test_expert_leaves_round_trip_exactly():
    _, params = jax_params(moe_top_k=2)
    host = jax.device_get(params)
    state = params_from_jax(host)
    module = port_module(params, moe_top_k=2)
    assert set(state) == set(module.state_dict())
    np.testing.assert_array_equal(state["blocks.1.w_up"].numpy(),
                                  np.asarray(host["blocks"]["w_up"])[1])
    back = params_to_jax(state)
    assert set(back["blocks"]) == set(host["blocks"]) == set(MOE_BLOCK_PARAMS)
    for name in MOE_BLOCK_PARAMS:
        np.testing.assert_array_equal(back["blocks"][name].numpy(),
                                      np.asarray(host["blocks"][name]), err_msg=name)


@pytest.mark.parametrize("names", [
    MOE_BLOCK_PARAMS + ("win", "bin", "wout", "bout"),  # both whole
    ("ln1", "wqkv", "bqkv", "wo", "bo", "ln2", "router", "w_up"),  # neither whole
], ids=["both", "neither"])
def test_a_block_with_both_or_neither_set_raises(names):
    with pytest.raises(KeyError):
        block_params(names)


MOE_CONFIG = dict(vocab_size=61, d_model=16, n_layers=2, n_heads=2, d_ff=32, seq_len=64,
                  flash=False, moe_experts=4, moe_top_k=2)


def test_a_jax_moe_artifact_loads_in_the_port_leaf_for_leaf(tmp_path):
    model = jax_tf.make_model(**MOE_CONFIG)
    params = model.init(jax.random.PRNGKey(1), _serving_mesh(model))
    jax_export.save_inference_model(str(tmp_path), "transformer", params,
                                    config=MOE_CONFIG, step=3)
    art = load_inference_model(str(tmp_path), device="cpu")
    assert art.model.config.moe_experts == 4
    state = art.module.state_dict()
    host = jax.device_get(params)
    for name in MOE_BLOCK_PARAMS:
        for i in range(MOE_CONFIG["n_layers"]):
            np.testing.assert_array_equal(state[f"blocks.{i}.{name}"].numpy(),
                                          np.asarray(host["blocks"][name])[i], err_msg=name)


def test_a_port_moe_artifact_loads_in_the_jax_package_leaf_for_leaf(tmp_path):
    module = torch_tf.make_model(**MOE_CONFIG).build(
        device="cpu", generator=torch.Generator().manual_seed(1))
    save_inference_model(str(tmp_path), "transformer", module, config=MOE_CONFIG, step=5)
    jm = jax_tf.make_model(**MOE_CONFIG)
    art = jax_export.load_inference_model(str(tmp_path), mesh=_serving_mesh(jm))
    got = jax.device_get(art.params)
    want = params_to_jax(module.state_dict())
    _, tree = read_artifact(str(tmp_path))
    assert set(got["blocks"]) == set(tree["blocks"]) == set(MOE_BLOCK_PARAMS)
    for name in MOE_BLOCK_PARAMS:
        np.testing.assert_array_equal(np.asarray(got["blocks"][name]),
                                      want["blocks"][name].numpy(), err_msg=name)


def test_lm_serving_refuses_moe_in_both_packages():
    for package in (jax_tf, torch_tf):
        cfg = package.TransformerConfig(**CFG)
        for make in (package.make_prefill_step, package.make_decode_step):
            with pytest.raises(NotImplementedError, match="dense FFN"):
                make(cfg)
