"""find a cell's parts by name.

`BENCHMARK.json` names each cell's configuration and traffic; the files
are `configs/<config>.json` and `traffic/<traffic>.json` under the
benchmark's folder, the traffic file's `kind` names the module that
runs it, `runners/<kind>.py`, the limits of the cell's comparison are
`limits/<cell>.json`, and the part of a per-layer metric's name before the
first dot names its reader, `metrics/<family>.py`. Adding a cell, a
configuration, a traffic mix or a metric adds files and manifest entries;
no code here changes.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional

HERE = Path(__file__).resolve().parent
REPO = HERE.parent


class Cell(NamedTuple):
    name: str
    root: Path  # the benchmark's folder
    chips: int
    config: Dict  # the configuration file
    traffic: Dict  # the traffic file
    limits: Dict[str, float]  # the comparison's limits
    end_to_end: List[Dict]  # the manifest's metrics this cell reports
    per_layer: List[Dict]


def _read(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: Dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def load(name: str, repo: Optional[Path] = None) -> Cell:
    """the cell `name` of `<repo>/BENCHMARK.json`, its files found under the
    folder beside this module's name in `repo` (default: this checkout)."""
    repo = Path(repo) if repo is not None else REPO
    manifest = _read(repo / "BENCHMARK.json")
    entry = next((w for w in manifest["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in {repo / 'BENCHMARK.json'}")
    here = repo / HERE.name
    limits_path = here / "limits" / f"{name}.json"
    return Cell(
        name=name,
        root=here,
        chips=int(entry["chips"]),
        config=_read(here / "configs" / f"{entry['config']}.json"),
        traffic=_read(here / "traffic" / f"{entry['traffic']}.json"),
        limits=_read(limits_path) if limits_path.exists() else {},
        end_to_end=[m for m in manifest["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in manifest["per_layer"] if _reports(m, name)],
    )


def _module(root: Path, part: str, name: str):
    """`<root>/<part>/<name>.py` as the module `<package>.<part>.<name>`."""
    full = f"{__package__}.{part}.{name}"
    if full not in sys.modules:
        path = Path(root) / part / f"{name}.py"
        if not path.exists():
            raise KeyError(f"no {part[:-1]} {name!r}: {path} does not exist")
        spec = importlib.util.spec_from_file_location(full, path)
        module = importlib.util.module_from_spec(spec)
        sys.modules[full] = module
        spec.loader.exec_module(module)
    return sys.modules[full]


def runner(cell: Cell):
    """the module that runs the cell's traffic: `runners/<kind>.py`."""
    return _module(cell.root, "runners", cell.traffic["kind"])


def reader(cell: Cell, metric: str):
    """the module that reads a per-layer metric: `metrics/<family>.py`, the
    family being the part of the name before the first dot."""
    return _module(cell.root, "metrics", metric.split(".", 1)[0])
