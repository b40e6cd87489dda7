"""The port's layout planner (`edl_tpu_torch.parallel.planner`) against the
JAX package's (`edl_tpu.parallel.planner`).

Both are pure Python float arithmetic over the same closed forms (the
pipeline bubble and stash, the ZeRO-1 bytes, the bandwidth model), so for
one explicitly given `Topology` and `ModelProfile` the scored table, its
reasons, the argmin and the data-only baseline must be EQUAL, not close:
the whole ``Plan.to_dict()``, over a grid of card counts, slice shapes,
global batches and schedule restrictions (all searched, pipelining
forbidden, one schedule). Only `Topology`'s defaults differ: the port's
are an H100's.
"""

import dataclasses

import pytest

from edl_tpu.parallel import planner as jax_planner
from edl_tpu_torch import parallel as torch_parallel
from edl_tpu_torch.parallel import collective, planner
from edl_tpu_torch.tools import mfu

FABRIC = dict(chip_flops=4.0e14, hbm_bytes=20.0 * 2**30, ici_bps=3.0e11, dcn_bps=2.5e10)
PROFILES = {
    # an LM: stackable layers, compute and stash both matter
    "lm": dict(param_bytes=4.9e8, replicated_bytes=2.0e8, n_layers=12,
               flops_per_sample=2.2e12, activation_bytes_per_microbatch=1.2e8),
    # collective-bound (no compute term): pipelines win, and one card's
    # memory holds no layout
    "bytes": dict(param_bytes=1.2e10, replicated_bytes=0.0, n_layers=8,
                  activation_bytes_per_microbatch=1.0e8),
}
SLICES = [(8,), (4, 4), (2, 2, 2, 2), (16,)]
CHIPS = (1, 2, 4, 6, 8, 16)
SCHEDULES = {"all": None, "none": (), "1f1b": ("1f1b",)}


def _both(profile, slices):
    return [(mod.Topology(slices=slices, **FABRIC), mod.ModelProfile(**PROFILES[profile]))
            for mod in (jax_planner, planner)]


@pytest.mark.parametrize("profile", sorted(PROFILES))
@pytest.mark.parametrize("slices", SLICES, ids=lambda s: "x".join(map(str, s)))
def test_plans_are_the_jax_packages(profile, slices):
    args = _both(profile, slices)
    compared = 0
    for n in CHIPS:
        if n > sum(slices):
            continue
        for batch in (32, 48):
            for sched_name, schedules in SCHEDULES.items():
                (jk, jv), (tk, tv) = [
                    _plan(mod, n, topo, prof, batch, schedules)
                    for mod, (topo, prof) in zip((jax_planner, planner), args)]
                assert (tk, tv) == (jk, jv), (n, batch, sched_name)
                compared += jk == "ok"
                cands = [[dataclasses.astuple(c) for c in mod.enumerate_candidates(
                    n, topo, prof, batch, schedules=schedules)]
                    for mod, (topo, prof) in zip((jax_planner, planner), args)]
                assert cands[1] == cands[0], (n, batch, sched_name)
            base = [mod.data_only_plan(n, topo, prof, 32).to_dict()
                    for mod, (topo, prof) in zip((jax_planner, planner), args)]
            assert base[1] == base[0], n
    assert compared > 0


def _plan(mod, n, topo, prof, batch, schedules):
    try:
        return "ok", mod.plan_layout(n, topo, prof, batch, schedules=schedules).to_dict()
    except ValueError as e:
        return "raise", str(e)


def test_the_grid_reaches_every_kind_of_verdict():
    """The grid above holds the hierarchical argmin, a pipelined argmin,
    infeasible rows with both reasons, and a card count no layout fits."""
    seen = set()
    for profile in PROFILES:
        for slices in SLICES:
            (_, _), (topo, prof) = _both(profile, slices)
            for n in CHIPS:
                if n > sum(slices):
                    continue
                try:
                    plan = planner.plan_layout(n, topo, prof, 48)
                except ValueError:
                    seen.add("no layout")
                    continue
                seen.add("hierarchical" if plan.hierarchical else "flat")
                if plan.axes_dict.get("pipe", 1) > 1:
                    seen.add("pipelined")
                for sc in plan.table:
                    if not sc.feasible:
                        seen.add("memory" if "HBM" in sc.reason else "batch")
    assert {"hierarchical", "flat", "pipelined", "memory", "no layout"} <= seen, seen


def test_topology_defaults_are_an_h100s():
    topo = planner.Topology(slices=(8,))
    assert topo.chip_flops == mfu.H100_PEAK_BF16_TFLOPS * 1e12 == 989e12
    assert topo.hbm_bytes == 80 * 2**30
    assert topo.ici_bps == collective.NVLINK_BYTES_PER_SEC == 450e9
    assert topo.dcn_bps == collective.INFINIBAND_BYTES_PER_SEC == 50e9
    assert [f.name for f in dataclasses.fields(planner.Topology)] == \
        [f.name for f in dataclasses.fields(jax_planner.Topology)]
    for name in ("ModelProfile", "Plan", "Topology", "data_only_plan", "plan_layout"):
        assert getattr(torch_parallel, name) is getattr(planner, name)
