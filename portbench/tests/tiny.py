"""Tiny copies of the benchmark's cells for tests on the CPU: a temporary
checkout holding this folder, a link to the program, and cells cut to a
few streams of 240 x 320 with the real settings otherwise."""

from __future__ import annotations

import json
import os
import shutil
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
REPO = HERE.parent

TINY_SERVE = dict(streams=3, clip_frames=6, height=240, width=320,
                  objects=10, min_size=24, max_size=64, warmup_calls=3,
                  checked_calls=3)


def checkout(tmp: Path) -> Path:
    """A temporary checkout: this folder copied, the program linked."""
    root = tmp / "co"
    shutil.copytree(HERE, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    os.symlink(REPO / "tpu_mot_torch", root / "tpu_mot_torch")
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    return root


def add_cell(root: Path, name: str, config: str, traffic: str,
             config_edit: dict, traffic_edit: dict,
             tracker_edit: dict | None = None) -> None:
    """Add cell `name`: copies of a configuration and a traffic mix with
    edits, written as new files, and a `workloads` entry."""
    pb = root / "portbench"
    conf = json.loads((pb / "configs" / f"{config}.json").read_text())
    conf.update(config_edit)
    conf["tracker"].update(tracker_edit or {})
    (pb / "configs" / f"{name}.json").write_text(json.dumps(conf))
    tr = json.loads((pb / "traffic" / f"{traffic}.json").read_text())
    tr.update(traffic_edit)
    (pb / "traffic" / f"{name}.json").write_text(json.dumps(tr))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(name=name, source="test",
                                 file=f"portbench/configs/{name}.json",
                                 reduced=[], why="test"))
    bench["workloads"].append(dict(name=name, config=name, traffic=name,
                                   chips=1, why="test"))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


def tiny_serve(root: Path, name: str = "tiny-serve") -> str:
    # roi_impl "pallas" samples the pyramid on the CPU as K1 does on the card.
    add_cell(root, name, "kcf-gray64-t128", "serve-1080p-s256", {},
             TINY_SERVE, dict(max_tracks=16, max_detections=16,
                              roi_impl="pallas"))
    return name


def tiny_detect(root: Path, name: str = "tiny-detect") -> str:
    """A detect cell at 240 x 320: yolov3-tiny at a 64 px input (its
    published widths and heads), 16 outputs, 16 track slots."""
    pb = root / "portbench"
    conf = json.loads((pb / "configs" /
                       "yolov3-tiny-416-kcf-gray64-t128.json").read_text())
    det = dict(conf["detector"], input_size=64, max_out=16)
    add_cell(root, name, "yolov3-tiny-416-kcf-gray64-t128",
             "detect-720p-s256", {"detector": det}, TINY_SERVE,
             dict(max_tracks=16, max_detections=16, roi_impl="pallas"))
    return name
