"""The port's analytic cost model, dry-run cell specs, roofline terms and
report tables (``repro_torch.analysis.costmodel``, ``.roofline``,
``.report``, ``repro_torch.launch.specs``) against the reference's.

The first tests mirror ``tests/test_costmodel_specs.py`` case for case on
the port alone.  Then, for every architecture x shape on the production
mesh ``MeshInfo(tp=16, dp=16)`` and its two-pod mesh, the port's values
equal the reference's to 1e-12 relative: the input specs (shapes, dtypes,
the sharding of every dim), ``train_cost`` / ``prefill_cost`` /
``decode_cost``, ``param_traffic_bytes``, ``active_params`` and
``model_flops``; ``activation_stash_bytes`` and ``remat_tradeoff`` over a
grid of pipelines given the same peak, ``roofline`` field for field given
the reference's peaks, ``hlo_collective_counts`` on the reference test's
text, and the roofline table from the same records.  Everything here runs
in this process (no device, no world).
"""

import math

import pytest

from repro import configs as jconfigs
from repro.analysis import costmodel as jcost
from repro.analysis import report as jreport
from repro.analysis import roofline as jrl
from repro.launch import specs as jspecs
from repro.models.params import MeshInfo as JMeshInfo

from repro_torch import configs
from repro_torch.analysis import costmodel, report, roofline as rl
from repro_torch.launch import specs as speclib
from repro_torch.models.params import MeshInfo

MI = MeshInfo(tp=16, dp=16)
MI_POD = MeshInfo(tp=16, dp=16, pod=2)
JMI = {"pod16x16": JMeshInfo(tp=16, dp=16),
       "pod2x16x16": JMeshInfo(tp=16, dp=16, pod=2, pod_axis="pod")}
PMI = {"pod16x16": MI, "pod2x16x16": MI_POD}
RTOL = 1e-12

# the reference's TPU peaks, given to both sides where a peak is priced
J_PEAKS = dict(peak_flops=jrl.PEAK_FLOPS, hbm_bytes_per_s=jrl.HBM_BW,
               link_bytes_per_s=jrl.ICI_BW)

HLO_TEXT = """
  %ag.1 = bf16[8,16]{1,0} all-gather(%p0), replica_groups={}
  %ar = f32[4] all-reduce(%x), to_apply=%sum
  %cp.2 = u8[4] collective-permute(%y), source_target_pairs={{0,1}}
  %cp.3 = u8[4] collective-permute-start(%y), source_target_pairs={{0,1}}
"""


def _close(a, b):
    assert math.isclose(a, b, rel_tol=RTOL, abs_tol=0.0), (a, b)


# --------------------------------------------------------------------------
# the reference's cases, on the port
# --------------------------------------------------------------------------

def test_all_cells_defined_and_divisible():
    """Every supported cell's shapes divide the production mesh."""
    for arch in configs.ARCH_IDS:
        cfg = configs.get(arch)
        for shape in speclib.SHAPES:
            ok, why = speclib.cell_supported(cfg, shape)
            if not ok:
                assert "full-attention" in why
                continue
            spec = speclib.input_specs(cfg, shape, MI)
            meta = spec["meta"]
            if spec["kind"] in ("train", "prefill"):
                assert meta["seq"] % MI.tp == 0
                assert meta["batch"] % MI.dp == 0
            else:
                shards = 1
                for ax in meta["seq_axes"]:
                    shards *= {"model": MI.tp, "data": MI.dp}[ax]
                assert meta["seq"] % shards == 0


def test_skip_list_matches_design():
    skipped = [a for a in configs.ARCH_IDS
               if not speclib.cell_supported(configs.get(a), "long_500k")[0]]
    assert sorted(skipped) == sorted([
        "qwen2-72b", "minitron-4b", "whisper-base",
        "kimi-k2-1t-a32b", "qwen3-moe-235b-a22b", "qwen2-vl-72b"])


def test_train_cost_scaling():
    cfg = configs.get("qwen2-72b")
    c1 = costmodel.train_cost(cfg, MI, B=256, S=4096,
                              n_active=72e9, n_total=72e9)
    c2 = costmodel.train_cost(cfg, MI, B=512, S=4096,
                              n_active=72e9, n_total=72e9)
    # flops scale with tokens; weight traffic does not
    assert 1.9 < c2.flops / c1.flops < 2.1
    assert c2.hbm_bytes < 2 * c1.hbm_bytes
    # remat adds a 4th pass
    c3 = costmodel.train_cost(cfg.replace(remat=False), MI, B=256, S=4096,
                              n_active=72e9, n_total=72e9)
    assert abs(c1.flops / c3.flops - 4 / 3) < 0.01


def test_decode_cost_weight_stationary():
    cfg = configs.get("kimi-k2-1t-a32b")
    base = costmodel.decode_cost(cfg, MI, B=128, S_ctx=32768,
                                 n_active=32e9, n_total=1.04e12)
    ws = costmodel.decode_cost(cfg.replace(moe_ws=True), MI, B=128,
                               S_ctx=32768, n_active=32e9, n_total=1.04e12)
    # 2-D-sharded experts slash the per-chip weight reads
    assert ws.hbm_bytes < base.hbm_bytes / 3


def test_moe_active_params():
    cfg = configs.get("qwen3-moe-235b-a22b")
    total = 235e9
    act = rl.active_params(cfg, int(total))
    assert act < total / 5  # top-8 of 128 experts


def test_roofline_dominant_and_mfu():
    """The reference's case at the peaks it was written for, given as
    arguments (the port's defaults are the H100's), then at the
    defaults."""
    r = rl.roofline({"flops": 197e12, "bytes accessed": 819e9 / 2},
                    coll_bytes_per_device=25e9, n_chips=1,
                    model_flops_total=98.5e12, **J_PEAKS)
    assert r.compute_s == pytest.approx(1.0)
    assert r.memory_s == pytest.approx(0.5)
    assert r.collective_s == pytest.approx(0.5)
    assert r.dominant == "compute"
    assert r.mfu == pytest.approx(0.5)
    assert r.useful_ratio == pytest.approx(0.5)
    h = rl.roofline({"flops": 989e12, "bytes accessed": 3.35e12 / 2},
                    coll_bytes_per_device=450e9 / 4, n_chips=1,
                    model_flops_total=989e12 / 2)
    assert (h.compute_s, h.memory_s, h.collective_s) == pytest.approx(
        (1.0, 0.5, 0.25))
    assert h.mfu == pytest.approx(0.5) and h.peak_flops == 989e12


def test_hlo_collective_counter():
    counts = rl.hlo_collective_counts(HLO_TEXT)
    assert counts["all-gather"] == 1
    assert counts["all-reduce"] == 1
    assert counts["collective-permute"] == 2


def test_param_traffic_bytes_modes():
    cfg = configs.get("kimi-k2-1t-a32b")
    full = costmodel.param_traffic_bytes(cfg, MI, decode=False)
    ws = costmodel.param_traffic_bytes(cfg.replace(moe_ws=True), MI,
                                       decode=True)
    assert ws < full / 3


# --------------------------------------------------------------------------
# parity with the reference, every cell on both production meshes
# --------------------------------------------------------------------------

def _p_entry(e):
    """A reference PartitionSpec entry as the port writes it."""
    if e is None:
        return None
    return (e,) if isinstance(e, str) else tuple(e)


@pytest.mark.parametrize("mesh", sorted(JMI))
@pytest.mark.parametrize("shape", list(jspecs.SHAPES))
@pytest.mark.parametrize("arch", list(jconfigs.ARCH_IDS))
def test_cell_matches_reference(arch, shape, mesh):
    jcfg, cfg = jconfigs.get(arch), configs.get(arch)
    jmi, mi = JMI[mesh], PMI[mesh]
    assert speclib.cell_supported(cfg, shape) == \
        jspecs.cell_supported(jcfg, shape)
    js, ps = jspecs.input_specs(jcfg, shape, jmi), \
        speclib.input_specs(cfg, shape, mi)
    assert ps["kind"] == js["kind"] and ps["meta"] == js["meta"]
    assert set(ps["inputs"]) == set(js["inputs"])
    for k, s in js["inputs"].items():
        got = ps["inputs"][k]
        assert got.shape == tuple(s.shape), k
        assert str(got.dtype).replace("torch.", "") == str(s.dtype), k
        assert ps["specs"][k] == tuple(_p_entry(e) for e in js["specs"][k]), k

    # the cost model at this cell's sizes, the reference's parameter count
    from repro.models.model import Model as JModel
    from repro.models.params import count_params as jcount
    from repro_torch.models import transformer
    from repro_torch.models.params import count_params
    n_total = jcount(JModel(jcfg, jmi).plan)
    assert count_params(transformer.model_plan(cfg, mi)) == n_total
    n_act = rl.active_params(cfg, n_total)
    assert n_act == jrl.active_params(jcfg, n_total)
    meta = js["meta"]
    tokens = meta["seq"] * meta["batch"]
    assert rl.model_flops(cfg, n_act, tokens) == \
        jrl.model_flops(jcfg, n_act, tokens)
    B, S = meta["batch"], meta["seq"]
    for kind in ("train", "prefill", "decode"):
        axes = meta.get("seq_axes", ("model",))
        a = costmodel.cost_for(cfg, mi, kind, B, S, n_act, n_total, axes)
        b = jcost.cost_for(jcfg, jmi, kind, B, S, n_act, n_total, axes)
        _close(a.flops, b.flops)
        _close(a.hbm_bytes, b.hbm_bytes)
    for decode in (False, True):
        _close(costmodel.param_traffic_bytes(cfg, mi, decode),
               jcost.param_traffic_bytes(jcfg, jmi, decode))


@pytest.mark.parametrize("arch", ["kimi-k2-1t-a32b", "qwen3-moe-235b-a22b"])
def test_weight_stationary_costs_match_reference(arch):
    """``moe_ws`` changes the decode's weight reads alike."""
    for mesh in JMI:
        cfg, jcfg = configs.get(arch).replace(moe_ws=True), \
            jconfigs.get(arch).replace(moe_ws=True)
        _close(costmodel.param_traffic_bytes(cfg, PMI[mesh], True),
               jcost.param_traffic_bytes(jcfg, JMI[mesh], True))
        a = costmodel.decode_cost(cfg, PMI[mesh], 128, 32768, 32e9, 1.04e12)
        b = jcost.decode_cost(jcfg, JMI[mesh], 128, 32768, 32e9, 1.04e12)
        _close(a.hbm_bytes, b.hbm_bytes)


PIPES = [(d, t, lr, n, pp, v) for d, t in ((1152, 2048), (8192, 4096))
         for lr, n, pp, v in ((13, 4, 2, 1), (8, 8, 4, 2), (26, 1, 1, 1),
                              (4, 4, 4, 1))]


@pytest.mark.parametrize("d_model,tokens,layers,n_micro,pp,vpp", PIPES)
def test_stash_and_remat_match_reference(d_model, tokens, layers, n_micro,
                                         pp, vpp):
    for remat in (False, True):
        for bpv in (2, 4):
            _close(rl.activation_stash_bytes(d_model, tokens, layers,
                                             n_micro, pp, vpp, remat, bpv),
                   jrl.activation_stash_bytes(d_model, tokens, layers,
                                              n_micro, pp, vpp, remat, bpv))
    for peak in (jrl.PEAK_FLOPS, rl.H100_PEAK_FLOPS):
        a = rl.remat_tradeoff(d_model, tokens, layers, n_micro, pp, vpp,
                              peak_flops=peak, handoff_s=0.25)
        b = jrl.remat_tradeoff(d_model, tokens, layers, n_micro, pp, vpp,
                               peak_flops=peak, handoff_s=0.25)
        assert a.keys() == b.keys()
        for k in a:
            _close(a[k], b[k])


ROOFS = [({"flops": 3.4e13, "bytes accessed": 7.9e10}, 1.98e10, 256, 2.4e16),
         ({"flops": 1e9, "bytes accessed": 5e12}, 1e6, 512, 1e11),
         ({"flops": 2e12, "bytes accessed": 1e9}, 9e12, 8, 1.6e13),
         ({}, 0.0, 1, 0.0)]


@pytest.mark.parametrize("case", range(len(ROOFS)))
def test_roofline_matches_reference_field_for_field(case):
    cost, coll, chips, mf = ROOFS[case]
    a = rl.roofline(cost, coll, chips, mf, **J_PEAKS).to_dict()
    b = jrl.roofline(cost, coll, chips, mf).to_dict()
    assert a.keys() == b.keys()
    for k in b:
        if isinstance(b[k], str):
            assert a[k] == b[k], k
        else:
            _close(a[k], b[k])


def test_hlo_collective_counts_match_reference():
    assert rl.hlo_collective_counts(HLO_TEXT) == \
        jrl.hlo_collective_counts(HLO_TEXT)


def test_collective_counts_of_a_ledger():
    ev = [dict(op="all_reduce"), dict(op="all_gather"),
          dict(op="all_gather"), dict(op="ppermute")]
    assert rl.collective_counts(ev) == {"all_reduce": 1, "all_gather": 2,
                                        "ppermute": 1}


def _records():
    """Dry-run records as both packages write the shared keys: a traced
    cell, a skipped one and a failed one."""
    r = jrl.roofline({"flops": 3.4e13, "bytes accessed": 7.9e10}, 1.98e10,
                     256, 2.4e16).to_dict()
    traced = dict(arch="gemma3-1b", shape="train_4k", status="traced",
                  params=999826048, roofline=r,
                  collective={"total_bytes": 1.98e10},
                  traced={"flops": 2.99e13, "bytes": 1.28e12},
                  memory={"argument_bytes": 3.7e8, "peak_live_bytes": 4.98e10},
                  trace_s=15.0)
    skipped = dict(arch="qwen2-72b", shape="long_500k", status="skipped",
                   why="skipped: pure full-attention arch (quadratic "
                       "long-context); see DESIGN.md §5")
    failed = dict(arch="xlstm-1.3b", shape="decode_32k",
                  status="trace_failed")
    return {(r_["arch"], r_["shape"]): r_ for r_ in (traced, skipped, failed)}


def test_report_tables_match_reference(tmp_path):
    recs = _records()
    assert report.roofline_table(recs) == jreport.roofline_table(recs)
    table = report.dryrun_table(recs)
    rows = table.splitlines()
    assert "traced GFLOPs/dev" in rows[0] and "peak live GB/dev" in rows[0]
    assert "| gemma3-1b | train_4k | traced | 1.0B | 29900.0 | 1280.00 " \
        "| 49.80 | 19800.0 | 15.0s |" in rows
    assert any("qwen2-72b | long_500k | skipped" in x for x in rows)
    # load_all reads the dry-run's file names, as the reference's
    import json
    for (arch, shape), r_ in recs.items():
        (tmp_path / f"pod16x16-zhybrid_16_8-{arch}-{shape}.json").write_text(
            json.dumps(r_))
    assert report.load_all(tmp_path, "pod16x16", "zhybrid_16_8") == \
        jreport.load_all(tmp_path, "pod16x16", "zhybrid_16_8")
