"""On the card: the reference against the port's CUDA path at the cells'
frame size, and a short run of each one-card cell."""

import pytest

from portbench import check, frames
from portbench.reference.report import Reference
from portbench.run import box_dicts, run_cell
from portbench.spec import load_cell


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [21, 2**31 + 22])
def test_reference_agrees_with_the_port_on_the_card(card, seed):
    import photohive_dsp_tpu_torch as pt
    cell = load_cell("photo_1080p.upload")
    cfg = cell.config["report_config"]
    img = frames.frames(seed, [(1080, 1920)], 1, card)[0]
    boxes = box_dicts(cell.config["boxes"], 1080, 1920)
    rep = pt.get_report(img, pt.set_bounding_boxes(boxes),
                        config=pt.ReportConfig(**cfg))
    got = check.from_report(rep, rep.to_json(), len(boxes))
    want = Reference(cfg, card).report(
        img, [(b["top"], b["bottom"], b["left"], b["right"])
              for b in boxes])
    numbers = check.combine([check.gaps(got, want, 1080 * 1920, cfg)])
    assert check.verdict(numbers, 1, 0, 1, check.required(True)), numbers


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["photo_1080p.upload", "corpus_mixed.host",
                                  "corpus_mixed.device"])
def test_short_run_on_the_card(card, name):
    out = run_cell(load_cell(name), 31, 1.0, False)
    assert out["correct"], out["check"]
    assert out["device"]["platform"] == "gpu"
