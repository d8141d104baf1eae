"""BENCHMARK.json against the files it names and the contract's rules."""

import re

from benchmark.harness import core

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_every_cell_names_a_config_and_a_traffic_that_exist():
    man = core.manifest()
    configs = {c["name"] for c in man["configs"]}
    for c in man["configs"]:
        assert (core.ROOT / c["file"]).is_file()
        assert c["file"].startswith("benchmark/")
        assert "model" in core.load_json(core.ROOT / c["file"])
    used = set()
    for w in man["workloads"]:
        assert w["config"] in configs
        used.add(w["config"])
        mix = core.mix_of(w)
        assert (core.BENCH / "traffic" / f"{mix['kind']}.py").is_file()
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    assert used == configs
    pairs = [(w["config"], w["traffic"]) for w in man["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_every_metric_has_a_reader_and_agrees_with_its_cells():
    man = core.manifest()
    cells = {w["name"] for w in man["workloads"]}
    e2e = {m["name"]: m for m in man["end_to_end"]}
    for m in man["end_to_end"] + man["per_layer"]:
        assert (core.BENCH / "metrics"
                / f"{m['name'].split('.')[0]}.py").is_file(), m["name"]
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
    for m in man["per_layer"]:
        moved = e2e[m["moves"]]
        # each cell listed reports the end-to-end metric it moves
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))
    for cell in cells:
        e = core.metrics_for(man, cell, False)
        assert "setup_s" in {m["name"] for m in e} and len(e) >= 2
        assert core.metrics_for(man, cell, True)
    for m in man["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25


def test_layer_names_are_spelled_alike():
    man = core.manifest()
    by_base = {}
    for m in man["per_layer"]:
        by_base.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_base.values())


def test_names_and_limits():
    man = core.manifest()
    for w in man["workloads"]:
        for k in ("name", "config", "traffic"):
            assert NAME.match(w[k])
        mix = core.mix_of(w)
        assert mix["limits"] and all(v > 0 for v in mix["limits"].values())
    assert 1 <= man["run_seconds"] <= 51
    assert man["command"][:2] == ["python3", "benchmark/run.py"]
