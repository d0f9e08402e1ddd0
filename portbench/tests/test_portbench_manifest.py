"""BENCHMARK.json and the files it names: found by name, and the manifest
check."""
import copy
import importlib
import json

import pytest

from portbench import manifest
from portbench import weights as W
from portbench.reference import deepseek_v2

BENCH = manifest.Bench(manifest.HERE.parent)


def test_manifest_has_no_problems():
    assert manifest.problems(BENCH) == []


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH.data["workloads"]])
def test_every_file_of_a_cell_is_found_by_name(cell):
    w = BENCH.cell(cell)
    cfg = BENCH.config(w["config"])
    mix = BENCH.traffic(w["traffic"])
    assert importlib.import_module(f"portbench.kinds.{mix['kind']}").Load
    assert BENCH.check(cell)["limits"]
    assert cfg["num_hidden_layers"] >= 1
    for m in BENCH.per_layer(cell):
        assert callable(BENCH.reader(m["name"]))
    assert {m["name"] for m in BENCH.end_to_end(cell)} >= {"setup_s"}


def _broken(mutate):
    b = copy.copy(BENCH)
    b.data = copy.deepcopy(BENCH.data)
    mutate(b.data)
    return manifest.problems(b)


@pytest.mark.parametrize("mutate", [
    lambda d: d["workloads"][0].update(name="bad name"),
    lambda d: d["end_to_end"][1].update(unit="tokens per second"),
    lambda d: d["per_layer"][0].pop("workloads"),
    lambda d: d["per_layer"][2].update(workloads=["jamba52b.decode-chat8"]),
    lambda d: d["end_to_end"][1].update(bound=0.3),
    lambda d: d.update(run_seconds=52),
    lambda d: d["configs"][0].update(name="µ"),
], ids=["space in a name", "space in a unit", "cells not listed",
        "cell lacks moves", "bound over 0.25", "run_seconds", "non-ascii"])
def test_manifest_check_catches(mutate):
    assert _broken(mutate)


def _with_config(tmp_path, mutate):
    """The manifest's problems with its first configuration's file changed
    by ``mutate`` (the files copied under ``tmp_path``)."""
    b = copy.copy(BENCH)
    b.data = copy.deepcopy(BENCH.data)
    b.root = tmp_path
    for i, c in enumerate(b.data["configs"]):
        cfg = BENCH.config(c["name"])
        if i == 0:
            mutate(cfg)
        (tmp_path / c["file"]).parent.mkdir(parents=True, exist_ok=True)
        (tmp_path / c["file"]).write_text(json.dumps(cfg))
    return manifest.problems(b)


def test_a_model_type_brings_its_module_of_layer_kinds(tmp_path):
    # deepseek-moe's widths read as a deepseek_v2: its module gives every
    # layer the mixer "mla", which it defines
    assert _with_config(tmp_path,
                        lambda cfg: cfg.update(model_type="deepseek_v2")) == []
    cfg = BENCH.config(BENCH.data["configs"][0]["name"])
    assert W.kinds_module(cfg) is None
    assert W.kinds(dict(cfg, model_type="deepseek_v2"))["mla"] \
        is deepseek_v2.KINDS["mla"]


@pytest.mark.parametrize("break_it", [
    lambda m: m.setattr(deepseek_v2, "KINDS", {}),
    lambda m: m.setattr(deepseek_v2, "layer_kind",
                        lambda cfg, l: ("mla", "swa")),
], ids=["module lacks its kind", "ffn defined nowhere"])
def test_manifest_check_catches_a_kind_defined_nowhere(tmp_path, monkeypatch,
                                                       break_it):
    break_it(monkeypatch)
    problems = _with_config(tmp_path,
                            lambda cfg: cfg.update(model_type="deepseek_v2"))
    assert problems and all("is defined nowhere" in p for p in problems)


def test_config_files_hold_the_port_spec_widths():
    for c in BENCH.data["configs"]:
        cfg = BENCH.config(c["name"])
        spec = cfg["port"]["spec"]
        assert spec["n_layers"] == cfg["num_hidden_layers"]
        assert spec["d_model"] == cfg["hidden_size"]
        assert spec["n_heads"] == cfg["num_attention_heads"]
        assert spec["n_kv_heads"] == cfg["num_key_value_heads"]
        assert spec["vocab"] == cfg["vocab_size"]
        assert spec["moe"]["top_k"] == cfg["num_experts_per_tok"]
        for key in c["reduced"]:
            assert key in cfg["reduced"]
