"""The harness finds a cell's files by name, so a new configuration,
traffic mix, metric or layer's kernel names comes in as a new file."""

import json
import shutil

import pytest

import core


def test_kernels_sorted_into_layers_by_the_pattern_files():
    pats = core.layer_patterns()
    assert core.layer_of("void density_band_t<0>(DensityBandArgs)", pats) \
        == "sweeps"
    assert core.layer_of("void force_band_t<1>(ForceBandArgs)", pats) \
        == "sweeps"
    assert core.layer_of("void fused_band_t(FusedBandArgs)", pats) == "sweeps"
    assert core.layer_of("void at::native::elementwise_kernel<128, 2>", pats) \
        == "torch_ops"
    assert core.layer_of("void at_cuda_detail::cub::DeviceRadixSortOnesweep"
                         "Kernel<", pats) == "torch_ops"
    assert core.layer_of("Memcpy DtoH (Device -> Pinned)", pats) == "torch_ops"
    assert core.layer_of("void (anonymous namespace)::new_kernel_t(A)",
                         pats) is None
    rec = {"profile": {"device_s": {"void density_band_t<0>(A)": 0.25,
                                    "void force_band_t<0>(B)": 0.5,
                                    "Memcpy DtoH": 0.125,
                                    "void new_kernel_t(C)": 0.0625},
                       "steps": 10},
           "layers": pats, "bound": {"bound_s": 0.0075}}
    assert core.layer_seconds(rec, "sweeps") == 0.75
    assert core.layer_seconds(rec, "torch_ops") == 0.125
    assert core.layer_ops(rec, None) == {"void new_kernel_t(C)": 0.0625}
    assert core.reader("sweeps.device_ms_per_step")(rec) == 75.0
    assert core.reader("sweeps.roofline_pct")(rec) == 10.0
    assert core.reader("torch_ops.device_ms_per_step")(rec) == 12.5


def test_a_kernel_two_layers_claim_is_an_error(tmp_path):
    (tmp_path / "layers").mkdir()
    (tmp_path / "layers" / "sweeps.a.json").write_text(
        json.dumps({"patterns": ["band_t"]}))
    (tmp_path / "layers" / "binning.a.json").write_text(
        json.dumps({"patterns": ["force_"]}))
    pats = core.layer_patterns(tmp_path)
    assert core.layer_of("void density_band_t<0>", pats) == "sweeps"
    with pytest.raises(ValueError, match="binning, sweeps"):
        core.layer_of("void force_band_t<0>", pats)


def test_every_listed_metric_has_a_reader_and_every_cell_its_files():
    bench = core.load_bench()
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(core.reader(m["name"]))
    for w in bench["workloads"]:
        cell = core.cell(bench, w["name"])
        assert cell["config"]["sph"]["num_particles"] > 0
        assert cell["traffic"]["block"] > 0
        assert set(cell["limits"]) >= {"count_rows_differ", "rho_rel_err"}
        assert [m["name"] for m in cell["end_to_end"]][-1] == "setup_s"


def test_new_files_are_found_without_editing_any(tmp_path):
    here = tmp_path / "bench_port"
    shutil.copytree(core.HERE, here,
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    before = {p: p.read_bytes() for p in here.rglob("*") if p.is_file()}
    bench = core.load_bench()
    (here / "configs" / "new_cfg.json").write_text(
        (here / "configs" / "splash_1m_exact.json").read_text())
    (here / "traffic" / "perstep.json").write_text(json.dumps(
        {"why": "t", "block": 1, "checked_steps": 4,
         "checked_solves": 2}))
    (here / "limits" / "new_cfg.json").write_text("{}")
    (here / "metrics" / "new.metric.py").write_text(
        "def read(record):\n    return record.get('x')\n")
    (here / "layers" / "sweeps.renamed.json").write_text(
        json.dumps({"patterns": ["band_walk_v2"]}))
    (here / "layers" / "binning.prepare.json").write_text(
        json.dumps({"patterns": ["bin_prepare_t"]}))
    shutil.copy(core.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    bench["configs"].append({"name": "new_cfg",
                             "file": "bench_port/configs/new_cfg.json"})
    bench["workloads"].append({"name": "new_cfg.perstep", "config": "new_cfg",
                               "traffic": "perstep", "chips": 1})
    bench["per_layer"].append({"name": "new.metric", "unit": "1",
                               "workloads": ["new_cfg.perstep"]})
    cell = core.cell(bench, "new_cfg.perstep", tmp_path, here)
    assert cell["traffic"]["block"] == 1
    assert [m["name"] for m in cell["per_layer"]] == ["new.metric"]
    assert core.read_metrics(cell["per_layer"], {"x": 2.5}, here) == {
        "new.metric": {"value": 2.5, "unit": "1"}}
    assert core.read_metrics(cell["per_layer"], {}, here) == {}
    pats = core.layer_patterns(here)
    assert core.layer_of("void band_walk_v2<0>", pats) == "sweeps"
    assert core.layer_of("void bin_prepare_t(PrepareArgs)", pats) \
        == "binning"
    assert "density_band_t" in pats["sweeps"]
    # a new layer's file adds a layer and leaves the old ones' readings
    rec = {"profile": {"device_s": {"void bin_prepare_t(A)": 0.25,
                                    "void at::native::sort(B)": 0.5},
                       "steps": 10}}
    old = dict(rec, layers=core.layer_patterns())
    new = dict(rec, layers=pats)
    for name in ("torch_ops.device_ms_per_step", "sweeps.device_ms_per_step"):
        assert core.reader(name, here)(new) == core.reader(name)(old)
    assert core.layer_seconds(new, "binning") == 0.25
    for p, data in before.items():
        assert p.read_bytes() == data
