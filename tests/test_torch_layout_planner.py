"""The port's layout planner (``repro_torch.launch.plan_shardings``)
against the reference's: with the reference's peaks and its 16 GB card
patched into the port's modules, every candidate's three terms, peak
bytes and feasibility, and the ranking, exactly equal to the reference's
``plan_layout`` for every architecture and shape; with the port's own
constants (one H100: 989 TFLOP/s, 3.35 TB/s, 80 GB, 50 GB/s a card over
the host network) the winners it picks, pinned."""
import pytest

pytest.importorskip("torch")

from repro.config.base import SHAPES as REF_SHAPES  # noqa: E402
from repro.configs import get_arch as ref_get_arch  # noqa: E402
from repro.launch import plan_shardings as RPS  # noqa: E402
from repro.launch import roofline as RRL  # noqa: E402
from repro_torch.config.base import SHAPES  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_arch  # noqa: E402
from repro_torch.launch import plan_shardings as PS  # noqa: E402
from repro_torch.launch import roofline as RL  # noqa: E402


def _row(p) -> tuple:
    c = p.choice
    return ((c.tp_mode, c.attention, c.loss, c.mamba), p.compute_s,
            p.memory_s, p.collective_s, p.peak_temp_bytes, p.feasible)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_planner_equals_reference_at_its_constants(monkeypatch, arch):
    monkeypatch.setattr(RL, "PEAK_FLOPS", RRL.PEAK_FLOPS)
    monkeypatch.setattr(RL, "HBM_BW", RRL.HBM_BW)
    monkeypatch.setattr(RL, "LINK_BW", RRL.ICI_BW)
    monkeypatch.setattr(PS, "HBM_CAP", RPS.HBM_CAP)
    for name in SHAPES:
        for chips in (256, 512):
            best, ranked = PS.plan_layout(get_arch(arch), SHAPES[name], chips)
            rbest, rranked = RPS.plan_layout(ref_get_arch(arch),
                                             REF_SHAPES[name], chips)
            assert [_row(p) for p in ranked] == [_row(p) for p in rranked]
            assert _row(best) == _row(rbest)
            assert len(ranked) == 16


# (tp_mode, attention, loss, mamba) the port's constants pick on 256 cards;
# "sp" seq_parallel, "ar" allreduce, "c" chunked, "n" naive, "f" full
_TRANSFORMER = {"train_4k": "sp c c f", "prefill_32k": "sp c f f",
                "decode_32k": "ar n f f", "long_500k": "ar n f f"}
WINNERS = {a: _TRANSFORMER for a in ARCH_IDS}
WINNERS["falcon-mamba-7b"] = {"train_4k": "sp n c c", "prefill_32k": "sp n f c",
                              "decode_32k": "sp n f f", "long_500k": "sp n f f"}
WINNERS["jamba-1.5-large-398b"] = {
    "train_4k": "sp n c c", "prefill_32k": "sp n f c",
    "decode_32k": "ar n f f", "long_500k": "ar n f f"}
_WORDS = {"sp": "seq_parallel", "ar": "allreduce", "c": "chunked",
          "n": "naive", "f": "full"}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_planner_winners_on_h100_peaks(arch):
    for name in SHAPES:
        best, ranked = PS.plan_layout(get_arch(arch), SHAPES[name])
        want = tuple(_WORDS[w] for w in WINNERS[arch][name].split())
        c = best.choice
        assert (c.tp_mode, c.attention, c.loss, c.mamba) == want, name
        assert best.feasible and PS.HBM_CAP == 80e9
        assert best.step_s == min(p.step_s for p in ranked if p.feasible)
