"""Find a cell's configuration, traffic mix, table generator, reference,
program entry and metric readers by the names ``BENCHMARK.json`` and the
configuration give them.

Files are looked up under each of the benchmark's ``paths`` in turn, so a
later change adds a configuration, a mix or a metric as new files and new
entries without editing any file that is already there.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


@dataclasses.dataclass(frozen=True)
class Cell:
    """One entry of ``workloads``, with its configuration and traffic read."""

    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    end_to_end: tuple      # metric entries of BENCHMARK.json that apply
    per_layer: tuple
    bench: "Benchmark"


class Benchmark:
    """``BENCHMARK.json`` under ``root`` and the files its names lead to."""

    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())
        self.dirs = [self.root / p for p in self.spec["paths"]]
        self._modules: dict[Path, object] = {}

    def find(self, kind: str, name: str, suffix: str) -> Path:
        """``<path>/<kind>/<name><suffix>`` under the first benchmark path
        that has it."""
        for d in self.dirs:
            p = d / kind / f"{name}{suffix}"
            if p.is_file():
                return p
        raise FileNotFoundError(
            f"no {kind}/{name}{suffix} under {[str(d) for d in self.dirs]}")

    def config(self, name: str) -> dict:
        entry = _named(self.spec["configs"], name, "configuration")
        return json.loads((self.root / entry["file"]).read_text())

    def traffic(self, name: str) -> dict:
        return json.loads(self.find("traffic", name, ".json").read_text())

    def module(self, kind: str, name: str):
        """The Python file ``<kind>/<name>.py`` (a table generator, a
        reference, a program entry or a metric reader), loaded once."""
        path = self.find(kind, name, ".py")
        mod = self._modules.get(path)
        if mod is None:
            safe = re.sub(r"\W", "_", f"portbench_{kind}_{name}")
            spec = importlib.util.spec_from_file_location(safe, path)
            mod = importlib.util.module_from_spec(spec)
            sys.modules[safe] = mod
            spec.loader.exec_module(mod)
            self._modules[path] = mod
        return mod

    def hand_kernels(self) -> frozenset:
        """The program's hand-written kernels, pinned by name in
        ``hand_kernels/*.json`` (one file per source): the kernels layer's
        metrics count their device time, and every other device operation
        is glue."""
        names = set()
        for d in self.dirs:
            for p in sorted((d / "hand_kernels").glob("*.json")):
                names.update(json.loads(p.read_text())["kernels"])
        return frozenset(names)

    def reader(self, metric: str):
        return self.module("metrics", metric)

    def generator(self, config: dict):
        return self.module("tables", config["generator"])

    def reference(self, config: dict):
        return self.module("reference", config["reference"])

    def entry(self, config: dict):
        """The program entry ``entries/<entry>.py`` that the configuration
        names, or None where it names none (the harness's default)."""
        return self.module("entries", config["entry"]) \
            if "entry" in config else None

    def cell(self, name: str) -> Cell:
        w = _named(self.spec["workloads"], name, "workload")

        def applies(m):
            return "workloads" not in m or name in m["workloads"]

        return Cell(
            name=name, chips=int(w["chips"]), config_name=w["config"],
            config=self.config(w["config"]), traffic_name=w["traffic"],
            traffic=self.traffic(w["traffic"]),
            end_to_end=tuple(m for m in self.spec["end_to_end"]
                             if applies(m)),
            per_layer=tuple(m for m in self.spec["per_layer"] if applies(m)),
            bench=self)


def _named(entries, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r}; have "
                   f"{[e['name'] for e in entries]}")
