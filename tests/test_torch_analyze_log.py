"""The port's log analytics (``bundle_adjustment_tpu_torch.utils.analyze_log``)
against the JAX package's on the same run log, on the CPU:

- ``summarize`` equals the JAX function's, on ``events.jsonl`` and on the
  echoed console log of the same run (each parsed by both packages);
- the two-panel plot is written (1320 x 880, drawn on the CPU) beside the
  same summary, its title and labels in text chunks; the CLI prints the
  summary;
- the low-inlier-ratio warning prints the JAX event log's text.
"""

import contextlib
import io as pyio
import json

import pytest
import torch

from bundle_adjustment_tpu.utils import analyze_log as janalyze
from bundle_adjustment_tpu.utils.event_log import EventLog as JaxEventLog
from bundle_adjustment_tpu_torch.utils import analyze_log, io
from bundle_adjustment_tpu_torch.utils.event_log import EventLog

torch.set_num_threads(1)


def _run_log(tmp_path):
    """A small run through the port's event log: events.jsonl and its echo."""
    path, echo = str(tmp_path / "events.jsonl"), str(tmp_path / "console.log")
    log = EventLog(path, echo=True)
    with open(echo, "w") as fh, contextlib.redirect_stdout(fh):
        log.frame(0)
        log.keyframe_trigger(0, 0, "Initialization", {})
        log.frame(1)
        log.pose(1, 40, 60, 40 / 60)
        log.keyframe_trigger(1, 1, "Pixel Displacement", {"median_displacement_px": 25.0})
        log.lba(1, 1000.0, 100.0, 12, False, 0.05)
        log.frame(2)
        log.pose(2, 10, 50, 0.2)
        log.frame_discarded(2, "Low inlier ratio or insufficient inliers.")
        log.frame(3)
        log.pose(3, 45, 55, 45 / 55)
        log.keyframe_trigger(3, 2, "Parallax", {"median_parallax_deg": 2.0})
        log.lba(2, 2000.0, 2500.0, 3, True, 0.01)
        log.frame(4)
        log.pose(4, 50, 60, 50 / 60)
        log.keyframe_trigger(4, 3, "Relocalization", {})
        log.lba(3, 900.0, 300.0, 7, False, 0.02, global_ba=True)
    log.close()
    return path, echo


@pytest.mark.parametrize("form", ["jsonl", "text"])
def test_summarize_equals_jax(tmp_path, form):
    jsonl, echo = _run_log(tmp_path)
    path = jsonl if form == "jsonl" else echo
    events = analyze_log.load_events(path)
    assert events == janalyze.load_events(path)
    got, want = analyze_log.summarize(events), janalyze.summarize(janalyze.load_events(path))
    assert got == want
    assert got["frames"] == 5 and got["keyframes"] == 4 and got["ba_runs"] == 2
    assert got["ba_divergences"] == 1


def test_plot_is_written(tmp_path, capsys, monkeypatch):
    jsonl, _ = _run_log(tmp_path)
    events = analyze_log.load_events(jsonl)
    out = str(tmp_path / "analysis.png")
    summary = analyze_log.analyze_and_plot(events, out, device="cpu")
    assert summary == janalyze.summarize(events)
    img = io.read_png(out)
    assert img.shape == (880, 1320, 3)
    # the BA bars in tab:green and the black inlier-ratio line
    assert ((img == (44, 160, 44)).all(2)).sum() > 1000
    assert ((img == 0).all(2)).sum() > 100
    text = io.read_png_text(out)
    assert text["Title"] == "Keyframe quality (triggers color-coded by reason)"
    assert text["ylabel"] == "pose inlier ratio" and text["xlabel2"] == "BA run"
    assert all(r in text["legend"] for r in analyze_log.REASON_COLORS)
    assert analyze_log.main([jsonl, out, "--device", "cpu"]) == 0
    assert json.loads(capsys.readouterr().out) == summary
    # the plot is drawn on the card by default, which raises without one
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        analyze_log.analyze_and_plot(events, out)


def test_low_ratio_warning_text_equals_jax():
    texts = []
    for log_cls in (JaxEventLog, EventLog):
        buf = pyio.StringIO()
        with contextlib.redirect_stdout(buf):
            log_cls(echo=True).pose(5, 4, 20, 0.2)
        texts.append(buf.getvalue())
    assert "WARNING: Low inlier ratio" in texts[1]
    assert texts[0] == texts[1]
