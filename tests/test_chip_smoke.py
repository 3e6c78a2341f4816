"""chip_smoke.py's phases at a tiny size on the CPU backend.

Each phase runs its own parity check; here the accelerator probe is
patched to answer "present" so the automatic dispatch picks the device
path, which JAX then runs on the CPU.  The run on the card is
`python chip_smoke.py`.
"""
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402

TINY_PANEL = dict(n_haps=4, length=256_000, n_queries=2,
                  query_len=(40_000, 80_000))


@pytest.fixture
def log():
    from pgrtk.utils.dispatch import log as pkg_log

    h = chip_smoke.DispatchLog()
    pkg_log.addHandler(h)
    pkg_log.setLevel("INFO")
    h.reset()
    yield h
    pkg_log.removeHandler(h)


@pytest.fixture(scope="module")
def panel_dir(tmp_path_factory):
    from pgrtk.utils import synth

    work = str(tmp_path_factory.mktemp("panel"))
    panel = synth.region_panel(1, **TINY_PANEL)
    chip_smoke.write_panel(work, panel)
    return work, panel


@pytest.fixture
def device_dispatch(monkeypatch):
    from pgrtk.utils import dispatch

    monkeypatch.setattr(dispatch, "_accel", True)
    monkeypatch.setenv("PGRTK_DEVICE_MIN_BASES", "1")


def test_main_refuses_cpu_before_any_phase(capsys):
    with pytest.raises(SystemExit) as e:
        chip_smoke.main([])
    assert e.value.code not in (0, None)
    assert "phase " not in capsys.readouterr().out


def test_region_panel_shape():
    from pgrtk.utils import synth

    p = synth.region_panel(1, **TINY_PANEL)
    assert [len(s) for _n, s in p["haps"]] == [256_000] * 4
    assert p["cnv_haps"] == [0]
    assert all(40_000 <= len(q) <= 80_000 for _n, q in p["queries"])
    bgn, end = p["cnv"]
    q0 = p["queries"][0][1]
    assert len(q0) > end - bgn  # query 0 covers the CNV block


def test_phase_mode2_cli(panel_dir, log, device_dispatch):
    work, _panel = panel_dir
    res = chip_smoke.phase_mode2_cli(work, log)
    assert res["identical_files"] == 4  # .hit + .fa per query
    assert res["chain_groups"] > 0


def test_phase_mode1_cli(panel_dir, log):
    work, _panel = panel_dir
    res = chip_smoke.phase_mode1_cli(work, log)
    assert res["identical_files"] == 4


def test_phase_sort_link(panel_dir, log):
    work, _panel = panel_dir
    if not os.path.exists(os.path.join(work, "panel.mdb")):
        from pgrtk.cli import pgr_mdb

        pgr_mdb.main([os.path.join(work, "archives.txt"),
                      os.path.join(work, "panel"), "-s"])
    res = chip_smoke.phase_sort_link(work, min_rows=1000)
    assert res["links"] > 0


def test_phase_wfa(panel_dir):
    _work, panel = panel_dir
    res = chip_smoke.phase_wfa(
        panel, dict(n_pairs=16, min_len=256, max_len=1024), seed=3)
    assert res["on_device"] > 0 and res["variants"] > 0


def test_phase_e2e():
    res = chip_smoke.phase_e2e(
        dict(B=2, L=524_288, qchunk=8, n_index_keys=65_536))
    assert res["n_t_filtered"] > 0
    assert res["chain_groups"] > 0 and res["index_pairs"] > 0


def test_phase_four_cards_on_virtual_devices():
    # the card run's 32 haplotypes (8 per device), at a tiny length: the
    # tripled block's carriers must fit the v2 bucket rows
    res = chip_smoke.phase_four_cards(n_devices=4, per_device=8,
                                      length=131_072)
    assert set(res["device_sets"].values()) == {4}
    assert res["chain_groups"] == 32 * 32
