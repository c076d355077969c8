"""Cells, configurations, mixes, pipelines, loops, references and metric
readers, found by name.

Nothing here lists a configuration, a mix, a pipeline or a metric:
``BENCHMARK.json`` names them, and each lives in a file of its own under
``benchmark/``:

* a cell: an entry of ``workloads`` (configuration, traffic, chips);
* a configuration: the ``file`` of its ``configs`` entry (JSON);
* a traffic mix: ``benchmark/mixes/<traffic>.json``;
* a pipeline: ``benchmark/pipelines/<pipeline>.py``, named by the
  configuration's ``pipeline`` (``frontend`` where it names none): what the
  run builds of the program, and how its outputs are judged
  (:mod:`benchmark.pipelines`);
* a reference: ``benchmark/reference/<reference>.py``, named by the
  configuration's ``reference`` (``sift`` where it names none), which the
  pipeline judges the program's outputs against;
* a loop: ``benchmark/loops/<loop>.py``, named by the mix's ``loop``
  (:mod:`benchmark.loops`);
* a metric: a reader ``benchmark/metrics/<name>.py``, or, for a name
  ``<base>.<split>``, ``benchmark/metrics/<base>.py``, whose ``read(run)``
  returns the value or None where the run gives it nothing to read.

A configuration's keys are the harness's own (:data:`HARNESS_KEYS`) or
settings of the program under its own names, which the pipeline hands on
(its ``settings()``); a key that is neither ends the run.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

# Read by the harness (frames, loops, the comparison), never by the program.
HARNESS_KEYS = ("name", "source", "height", "width", "tf32", "camera_hz", "camera", "scene",
                "motion", "limits", "assumed", "reduced", "pipeline", "reference")


class Cell:
    """One workload of ``BENCHMARK.json`` with its configuration, its mix
    and the metrics it reports."""

    def __init__(self, name: str, root: Path = ROOT):
        bench = json.loads((root / "BENCHMARK.json").read_text())
        by_name = {w["name"]: w for w in bench["workloads"]}
        if name not in by_name:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                           f"(it has {', '.join(sorted(by_name))})")
        self.root = root
        self.workload = by_name[name]
        self.name = name
        self.chips = int(self.workload["chips"])
        configs = {c["name"]: c for c in bench["configs"]}
        self.config = json.loads((root / configs[self.workload["config"]]["file"]).read_text())
        self.mix = json.loads((root / "benchmark" / "mixes"
                               / f"{self.workload['traffic']}.json").read_text())
        self.pipeline = self.config.get("pipeline", "frontend")
        self.reference = self.config.get("reference", "sift")
        self.end_to_end = [m for m in bench["end_to_end"] if self._reports(m)]
        self.per_layer = [m for m in bench["per_layer"] if self._reports(m)]

    def _reports(self, metric: dict) -> bool:
        return "workloads" not in metric or self.name in metric["workloads"]

    def metrics(self, trace: bool) -> list[dict]:
        """The entries this run reports: per-layer with a trace, else end-to-end."""
        return self.per_layer if trace else self.end_to_end

    def module(self, kind: str, name: str) -> ModuleType:
        """``benchmark/<kind>/<name>.py`` of this cell's root."""
        path = self.root / "benchmark" / kind / f"{name}.py"
        if not path.is_file():
            raise FileNotFoundError(f"no {kind} file {name!r} under {path.parent}")
        return _load(path, f"benchmark_{kind}_{name}")


def _load(path: Path, module_name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(module_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reader(name: str, root: Path = ROOT) -> ModuleType:
    """The reader module of metric ``name``: ``metrics/<name>.py``, else
    ``metrics/<base>.py`` for ``<base>.<split>``."""
    metrics = root / "benchmark" / "metrics"
    for stem in (name, name.split(".")[0]):
        path = metrics / f"{stem}.py"
        if path.is_file():
            return _load(path, f"benchmark_metric_{stem}")
    raise FileNotFoundError(f"no reader for metric {name!r} under {metrics}")
