"""Durable workflows: checkpointed DAGs that survive driver restarts.

Reference: ``python/ray/workflow/`` (SURVEY.md §2.5) — steps are logged to
storage before/after execution; ``resume`` replays completed steps from
storage and re-executes the rest.  API:

    @workflow.step
    def fetch(x): ...

    node = combine.bind(fetch.bind(1), fetch.bind(2))
    workflow.run(node, workflow_id="demo", storage="/path")
    workflow.resume("demo", node, storage="/path")   # after a crash

Each step runs as one cluster task; results are pickled per-step under
``<storage>/<workflow_id>/<step>.pkl`` with a ``status.json`` index, so a
resumed run only executes steps without a checkpoint (exactly-once per
successful step, at-least-once overall — the reference's model).
"""

from __future__ import annotations

import json
import pickle
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import ray_tpu_torch

_DEFAULT_STORAGE = "/tmp/rtt_workflows"


class WorkflowStepNode:
    """A DAG node: a step function bound to (possibly node-valued) args."""

    def __init__(self, fn, args: tuple, kwargs: dict, name: str,
                 max_retries: int):
        self.fn = fn
        self.args = args
        self.kwargs = kwargs
        self.name = name
        self.max_retries = max_retries

    def __repr__(self):
        return f"WorkflowStepNode({self.name})"


class _Step:
    def __init__(self, fn, name: Optional[str] = None, max_retries: int = 3):
        self._fn = fn
        self._name = name or fn.__name__
        self._max_retries = max_retries

    def bind(self, *args, **kwargs) -> WorkflowStepNode:
        return WorkflowStepNode(self._fn, args, kwargs, self._name,
                                self._max_retries)

    def options(self, *, name: Optional[str] = None,
                max_retries: Optional[int] = None) -> "_Step":
        return _Step(self._fn, name or self._name,
                     self._max_retries if max_retries is None else max_retries)

    def __call__(self, *args, **kwargs):
        return self._fn(*args, **kwargs)


def step(fn=None, **opts):
    """Decorator marking a function as a workflow step."""
    if fn is None:
        return lambda f: _Step(f, **opts)
    return _Step(fn)


# ------------------------------------------------------------------ storage
class _Store:
    def __init__(self, storage: str, workflow_id: str):
        self.root = Path(storage) / workflow_id
        self.root.mkdir(parents=True, exist_ok=True)

    def status_path(self) -> Path:
        return self.root / "status.json"

    def read_status(self) -> dict:
        try:
            return json.loads(self.status_path().read_text())
        except (FileNotFoundError, json.JSONDecodeError):
            return {"status": "RUNNING", "steps": {}}

    def write_status(self, st: dict) -> None:
        tmp = self.status_path().with_suffix(".tmp")
        tmp.write_text(json.dumps(st, indent=2))
        tmp.replace(self.status_path())

    def has_result(self, step_key: str) -> bool:
        return (self.root / f"{step_key}.pkl").exists()

    def load_result(self, step_key: str) -> Any:
        with open(self.root / f"{step_key}.pkl", "rb") as f:
            return pickle.load(f)

    def save_result(self, step_key: str, value: Any) -> None:
        tmp = self.root / f"{step_key}.pkl.tmp"
        with open(tmp, "wb") as f:
            pickle.dump(value, f)
        tmp.replace(self.root / f"{step_key}.pkl")


# ---------------------------------------------------------------- execution
def _topo_order(node: WorkflowStepNode) -> List[WorkflowStepNode]:
    """Post-order unique traversal: dependencies before dependents."""
    seen: Dict[int, WorkflowStepNode] = {}
    order: List[WorkflowStepNode] = []

    def visit(n):
        if id(n) in seen:
            return
        seen[id(n)] = n
        for a in list(n.args) + list(n.kwargs.values()):
            if isinstance(a, WorkflowStepNode):
                visit(a)
        order.append(n)

    visit(node)
    return order


def _step_keys(order: List[WorkflowStepNode]) -> Dict[int, str]:
    """Stable step keys: name + occurrence index in topo order."""
    counts: Dict[str, int] = {}
    keys = {}
    for n in order:
        i = counts.get(n.name, 0)
        counts[n.name] = i + 1
        keys[id(n)] = f"{n.name}_{i}"
    return keys


def run(node: WorkflowStepNode, *, workflow_id: Optional[str] = None,
        storage: str = _DEFAULT_STORAGE) -> Any:
    """Execute the DAG durably; returns the root node's result."""
    workflow_id = workflow_id or f"wf_{int(time.time() * 1000):x}"
    store = _Store(storage, workflow_id)
    status = store.read_status()
    if status.get("status") == "SUCCEEDED" and \
            status.get("root") in status["steps"]:
        return store.load_result(status["root"])

    order = _topo_order(node)
    keys = _step_keys(order)
    status["status"] = "RUNNING"
    status.setdefault("steps", {})
    status["root"] = keys[id(node)]
    store.write_status(status)

    # Independent branches run CONCURRENTLY: every step whose deps are
    # resolved is submitted; results are checkpointed as they complete.
    results: Dict[int, Any] = {}
    for n in order:
        key = keys[id(n)]
        if store.has_result(key):
            results[id(n)] = store.load_result(key)
            status["steps"][key] = "SUCCEEDED"

    def deps(n):
        return [a for a in list(n.args) + list(n.kwargs.values())
                if isinstance(a, WorkflowStepNode)]

    remaining = [n for n in order if id(n) not in results]
    in_flight: Dict[Any, WorkflowStepNode] = {}  # ref -> node
    failure: Optional[BaseException] = None
    while remaining or in_flight:
        launched = []
        for n in remaining:
            if failure is not None:
                break
            if all(id(d) in results for d in deps(n)):
                def resolve(v):
                    return results[id(v)] \
                        if isinstance(v, WorkflowStepNode) else v
                args = tuple(resolve(a) for a in n.args)
                kwargs = {k: resolve(v) for k, v in n.kwargs.items()}
                task = ray_tpu_torch.remote(max_retries=n.max_retries)(n.fn)
                in_flight[task.remote(*args, **kwargs)] = n
                launched.append(n)
        remaining = [n for n in remaining if n not in launched]
        if not in_flight:
            break
        done, _ = ray_tpu_torch.wait(list(in_flight), num_returns=1)
        n = in_flight.pop(done[0])
        key = keys[id(n)]
        try:
            value = ray_tpu_torch.get(done[0])
        except Exception as e:  # noqa: BLE001
            status["steps"][key] = "FAILED"
            failure = e
            continue  # drain remaining in-flight steps (checkpoint them)
        store.save_result(key, value)
        status["steps"][key] = "SUCCEEDED"
        store.write_status(status)
        results[id(n)] = value

    if failure is not None:
        status["status"] = "FAILED"
        store.write_status(status)
        raise failure
    status["status"] = "SUCCEEDED"
    store.write_status(status)
    return results[id(node)]


# ----------------------------------------------------------------- control
def resume(workflow_id: str, node: WorkflowStepNode, *,
           storage: str = _DEFAULT_STORAGE) -> Any:
    """Re-run a workflow: completed steps load from storage, the rest
    execute.  The DAG must be re-supplied (this framework does not pickle
    step closures into storage; the reference serializes the DAG — noted
    as a capability difference in the docstring)."""
    return run(node, workflow_id=workflow_id, storage=storage)


def get_status(workflow_id: str, *,
               storage: str = _DEFAULT_STORAGE) -> Optional[dict]:
    p = Path(storage) / workflow_id / "status.json"
    try:
        return json.loads(p.read_text())
    except (FileNotFoundError, json.JSONDecodeError):
        return None


def list_all(*, storage: str = _DEFAULT_STORAGE) -> List[Tuple[str, str]]:
    root = Path(storage)
    out = []
    if root.is_dir():
        for d in sorted(root.iterdir()):
            st = get_status(d.name, storage=storage)
            if st is not None:
                out.append((d.name, st.get("status", "UNKNOWN")))
    return out


def delete(workflow_id: str, *, storage: str = _DEFAULT_STORAGE) -> None:
    import shutil
    shutil.rmtree(Path(storage) / workflow_id, ignore_errors=True)
