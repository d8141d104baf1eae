"""A tiny CPU rehearsal of the loop and the last line, through the
test-only entry ``run_cell`` (``run.py`` itself refuses without a card)."""

import json

import pytest
import torch

from benchmark import run as R
from benchmark.harness import core
from benchmark.tests import _tiny

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("cell,trace", [("i2v512-b1", 0), ("i2v512-b2", 1),
                                        ("train512-b2", 0)])
def test_last_line_has_the_contract_keys(cell, trace):
    run, man = _tiny.run(cell, trace=trace)
    line = core.result(run, man, cell, bool(trace), {"platform": "cpu"})
    want = KEYS + (["breakdown"] if trace else []) + ["checks"]
    assert list(line) == want           # the numbers compared come last
    assert line["correct"] is True
    assert line["attempted"] == run.units > 0 and line["failed"] == 0
    names = {m["name"] for m in core.metrics_for(man, cell, bool(trace))}
    assert set(line["metrics"]) <= names
    if not trace:
        assert "setup_s" in line["metrics"]
    else:
        # no device: nothing read from a trace appears under a device metric
        assert not any(k.startswith(("idle_share", "resblock_roofline",
                                     "transformer_roofline"))
                       for k in line["metrics"])
    assert set(line["checks"]) == set(core.mix_of(
        core.cell_of(man, cell))["limits"])
    json.dumps(line)


def test_run_refuses_without_a_card(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = R.main(["--workload", "i2v512-b1", "--seed", "7", "--seconds", "1",
                 "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_same_seed_same_inputs_large_seed():
    from benchmark.traffic import i2v

    cfg = _tiny.config()
    seed = 2 ** 31 + 12345
    a = i2v.request(seed, 3, 2, cfg, {"fs": 24}, "cpu")
    b = i2v.request(seed, 3, 2, cfg, {"fs": 24}, "cpu")
    c = i2v.request(seed + 1, 3, 2, cfg, {"fs": 24}, "cpu")
    assert torch.equal(a.video, b.video) and torch.equal(a.tokens, b.tokens)
    assert a.noise_seeds == b.noise_seeds != c.noise_seeds
    assert not torch.equal(a.video, c.video)


def test_the_checked_request_is_a_uniform_draw_of_the_completed():
    from collections import Counter

    from benchmark.traffic import i2v

    counts = Counter()
    for seed in range(600):
        r = i2v.Sample(seed)
        recs = [{"idx": i} for i in range(3)]
        for rec in recs:
            r.offer(rec)
        counts[r.kept["idx"]] += 1
        assert sum(1 for rec in recs if rec) == 1   # the others dropped
    assert all(150 < counts[i] < 250 for i in range(3)), counts
