"""``bench_torch_e2e.py`` (3 store processes over the native transport,
each with its engine) against the JAX package's ``bench_e2e.py``.

Both at 8 groups, 3 stores, a 1 s warm-up and 2 s measured, window 2 of
batches of 8, their ``LAT`` and ``BRK`` rounds, the reference's result
file in a temporary directory: the port's ``extra`` holds every key of
the reference's but ``vs_baseline``/``baseline`` (not ported), neither
run errs, every store process exits 0 and the port's engines on the CPU
launch nothing (the plain tick).  Every group's leader is placed in the
port's run (``--converge 1.0``); the reference's stores stop waiting at
98 % of their share, rounded down (2 of 3 groups), so its placement is
held to that rule.  No committed record changes.

On a card (no JAX):
    python -m pytest --noconftest -m gpu tests/test_torch_bench_e2e.py
"""

import json

import pytest
import torch

from bench_script import finish, records, start

SMALL = ["--groups", "8", "--duration", "2", "--warmup", "1",
         "--window", "2", "--batch", "8"]
NOT_PORTED = {"vs_baseline", "baseline"}


def stores_placed(groups: int, stores: int, frac: float) -> int:
    """Leaders the reference's stores wait for: each its share's
    ``max(1, int(n * frac))``."""
    shares = [len(range(i, groups, stores)) for i in range(stores)]
    return sum(max(1, int(n * frac)) for n in shares)


def test_e2e_matches_the_reference_e2e(tmp_path):
    before = records()
    ref = start("bench_e2e.py", *SMALL,
                "--json-out", str(tmp_path / "ref.json"),
                env={"JAX_PLATFORMS": "cpu"})
    port = start("bench_torch_e2e.py", "--cpu", *SMALL, "--converge", "1.0",
                 "--out", str(tmp_path / "port.json"))
    ref_rc, ref_out, ref_err = finish(ref)
    port_rc, port_out, port_err = finish(port)
    assert ref_rc == 0, ref_err[-3000:]
    assert port_rc == 0, port_err[-3000:]
    want = json.loads((tmp_path / "ref.json").read_text())
    got = json.loads((tmp_path / "port.json").read_text())
    assert json.loads(port_out.splitlines()[-1]) == got
    assert set(got) == set(want) - NOT_PORTED
    assert set(got["extra"]) >= set(want["extra"]) - NOT_PORTED, \
        set(want["extra"]) - set(got["extra"])
    assert NOT_PORTED.isdisjoint(got["extra"])
    for rec in (want, got):
        extra = rec["extra"]
        assert extra["groups"] == 8 and extra["stores"] == 3
        assert extra["errors"] == 0, extra
        assert rec["value"] > 0
        assert extra["lowload_single_group_ack"]["n"] == 200
        assert extra["ack_breakdown"]["n"] == 150
    assert want["extra"]["leaders_placed"] >= stores_placed(8, 3, 0.98)
    extra = got["extra"]
    assert extra["leaders_placed"] == 8
    assert extra["store_exit_codes"] == [0, 0, 0]
    assert extra["device"] == "cpu" and extra["card"] is None
    assert extra["fused_tick_launches_per_store"] == [0, 0, 0]
    assert all(t > 0 for t in extra["engine_ticks_per_store"])
    assert records() == before


def test_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("the refusal needs a machine without a CUDA card")
    out = tmp_path / "e2e.json"
    rc, _, err = finish(start("bench_torch_e2e.py", "--groups", "8",
                              "--out", str(out)))
    assert rc != 0
    assert "no CUDA device is available" in err, err[-2000:]
    assert not out.exists()


# ---- on a card ----------------------------------------------------------------


@pytest.mark.gpu
def test_e2e_on_the_card_launches_once_a_tick(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the fused tick has no CPU mode")
    out = tmp_path / "e2e.json"
    rc, _, err = finish(start("bench_torch_e2e.py", *SMALL, "--converge",
                              "1.0", "--out", str(out)), timeout=300)
    assert rc == 0, err[-3000:]
    extra = json.loads(out.read_text())["extra"]
    assert extra["device"] == "cuda:0" and extra["card"]["name"]
    assert extra["store_exit_codes"] == [0, 0, 0]
    assert extra["fused_tick_launches_per_store"] == \
        extra["engine_ticks_per_store"]
    assert all(t > 0 for t in extra["engine_ticks_per_store"])
    assert extra["errors"] == 0 and extra["leaders_placed"] == 8
