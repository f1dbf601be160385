"""Runtime environments: per-task/actor env_vars, working_dir, py_modules.

Reference: ``python/ray/_private/runtime_env/`` (SURVEY.md §2.3) — the
driver uploads ``working_dir``/``py_modules`` into the GCS KV
(content-addressed zips); workers download+extract into a session cache,
chdir into the working dir and extend ``sys.path``, then undo after the
task (env application is per-task here since workers are pooled).

``pip`` isolation (reference: ``runtime_env={"pip": [...]}``) creates a
cached venv per requirement-set hash (``--system-site-packages`` so jax &
friends stay visible) and applies it per task by prefixing the venv's
site-packages on ``sys.path``; restore removes the path AND purges modules
imported from the venv, so the pooled worker stays clean.  Local
wheel/sdist paths are uploaded into the GCS KV at submit and materialized
on the executing host — installs run ``--no-index`` (zero-egress; index
requirements fail loudly).

``conda`` isolation (r3) creates/reuses a cached env per spec hash via the
first available mamba/micromamba/conda binary; ``container`` (r3) wraps
worker exec in podman/docker.  Both validate loudly as unsupported when no
binary exists on the host — which is the case in this image, so their tests
(tests/test_runtime_env_plugins.py) exercise them against in-tree fake
binaries; see PARITY.md for that caveat.
"""

from __future__ import annotations

import hashlib
import io
import os
import sys
import zipfile
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

SUPPORTED_KEYS = {"env_vars", "working_dir", "py_modules", "pip", "conda",
                  "container", "config"}
_URI_PREFIX = "kv://runtime_env/"
_EXCLUDE_DIRS = {"__pycache__", ".git", ".venv", "node_modules"}
_MAX_ZIP_BYTES = 64 * 1024 * 1024


def _conda_exe() -> Optional[str]:
    import shutil
    for name in ("mamba", "micromamba", "conda"):
        exe = shutil.which(name)
        if exe:
            return exe
    return None


def _container_exe() -> Optional[str]:
    import shutil
    for name in ("podman", "docker"):
        exe = shutil.which(name)
        if exe:
            return exe
    return None


def validate(runtime_env: Optional[dict]) -> None:
    if not runtime_env:
        return
    unknown = set(runtime_env) - SUPPORTED_KEYS
    if unknown:
        raise ValueError(
            f"unsupported runtime_env keys {sorted(unknown)}; supported: "
            f"{sorted(SUPPORTED_KEYS)}")
    # graceful validated-unsupported (reference: plugin validation at
    # submission): fail at submit with a clear message, not in a worker
    if runtime_env.get("conda") and _conda_exe() is None:
        raise ValueError(
            "runtime_env['conda'] requires a conda/mamba/micromamba "
            "binary on PATH; none found on this host "
            "(validated-unsupported)")
    if runtime_env.get("container") and _container_exe() is None:
        raise ValueError(
            "runtime_env['container'] requires a podman or docker binary "
            "on PATH; none found on this host (validated-unsupported)")


# ---------------------------------------------------------------- packaging
def _zip_dir(path: Path) -> bytes:
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as zf:
        for p in sorted(path.rglob("*")):
            if any(part in _EXCLUDE_DIRS for part in p.parts):
                continue
            if p.is_file():
                # fixed date_time → content-addressed hash is stable
                zi = zipfile.ZipInfo(str(p.relative_to(path)),
                                     date_time=(1980, 1, 1, 0, 0, 0))
                zi.external_attr = (p.stat().st_mode & 0xFFFF) << 16
                zf.writestr(zi, p.read_bytes())
    data = buf.getvalue()
    if len(data) > _MAX_ZIP_BYTES:
        raise ValueError(f"working_dir zip is {len(data)} bytes "
                         f"(limit {_MAX_ZIP_BYTES}); exclude large data")
    return data


def upload_dir(path: str, worker) -> str:
    """Zip + content-address + store in GCS KV; returns kv:// URI."""
    p = Path(path).resolve()
    if not p.is_dir():
        raise ValueError(f"runtime_env directory not found: {path}")
    data = _zip_dir(p)
    digest = hashlib.sha256(data).hexdigest()[:16]
    key = f"runtime_env/{digest}"
    uri = _URI_PREFIX + digest
    if not worker.rpc("kv_get", key=key).get("value"):
        worker.rpc("kv_put", key=key, value=data)
    return uri


_WHL_PREFIX = "kvwhl://runtime_env/"


def upload_file(path: Path, worker) -> str:
    """Content-address one local file (wheel/sdist) into the KV; the URI
    keeps the original filename — pip parses wheel metadata from it.

    prepare() runs on EVERY submit, so repeats are memoized by
    (path, mtime, size) ON THE WORKER (memo dies with the cluster
    connection — a module-level memo would survive init/shutdown/init and
    skip the upload into a fresh, empty KV) and KV existence is probed
    with kv_keys (metadata only) — never by fetching the blob back just
    to test truthiness."""
    memo = getattr(worker, "_renv_upload_memo", None)
    if memo is None:
        memo = worker._renv_upload_memo = {}
    st = path.stat()
    memo_key = (str(path), st.st_mtime, st.st_size)
    uri = memo.get(memo_key)
    if uri is not None:
        return uri
    data = path.read_bytes()
    digest = hashlib.sha256(data).hexdigest()[:16]
    key = f"runtime_env/{digest}"
    if not worker.rpc("kv_keys", prefix=key).get("keys"):
        worker.rpc("kv_put", key=key, value=data)
    uri = f"{_WHL_PREFIX}{digest}/{path.name}"
    memo[memo_key] = uri
    return uri


def prepare(runtime_env: Optional[dict], worker) -> Optional[dict]:
    """Driver-side: resolve local paths into uploaded URIs (at submit)."""
    if not runtime_env:
        return runtime_env
    validate(runtime_env)
    env = dict(runtime_env)
    wd = env.get("working_dir")
    if wd and not str(wd).startswith(_URI_PREFIX):
        env["working_dir"] = upload_dir(wd, worker)
    mods = env.get("py_modules")
    if mods:
        env["py_modules"] = [
            m if str(m).startswith(_URI_PREFIX) else upload_dir(m, worker)
            for m in mods]
    pip = env.get("pip")
    if pip:
        if isinstance(pip, str):
            pip = [pip]
        resolved = []
        for req in pip:
            req = str(req)
            if req.startswith(_WHL_PREFIX):
                resolved.append(req)
            elif Path(req).expanduser().is_file():
                # local wheel/sdist: ship through the KV so any host's
                # worker can install it (zero-egress: no index fetches)
                resolved.append(upload_file(Path(req).expanduser().resolve(),
                                            worker))
            else:
                resolved.append(req)
        env["pip"] = sorted(resolved)
    return env


# --------------------------------------------------------------- worker side
def _env_cache_root(worker) -> Path:
    """Root for ALL per-host runtime-env caches (zips and venvs).

    Session dir when the worker has one; else a per-user tmp dir — a
    world-shared path would let another user pre-seed content-addressed
    entries, so the dir is created 0o700 and a pre-existing dir with the
    wrong owner/mode is rejected (mkdir with exist_ok succeeds silently
    on an attacker-owned path)."""
    if worker.session is not None:
        return Path(worker.session.path)
    import getpass
    import stat as stat_mod
    import tempfile
    root = Path(tempfile.gettempdir()) / f"rtt_remote_{getpass.getuser()}"
    root.mkdir(mode=0o700, exist_ok=True)
    st = root.stat()
    if st.st_uid != os.getuid() or stat_mod.S_IMODE(st.st_mode) != 0o700:
        raise PermissionError(
            f"{root} exists with wrong owner/mode; refusing to use it "
            f"as the runtime_env cache")
    return root


def ensure_local(uri: str, worker) -> Path:
    """Fetch + extract a kv:// URI into the session cache; idempotent."""
    digest = uri[len(_URI_PREFIX):]
    cache = _env_cache_root(worker) / "runtime_env" / digest
    if cache.exists():
        return cache
    raw = worker.rpc("kv_get", key=f"runtime_env/{digest}").get("value")
    if raw is None:
        raise FileNotFoundError(f"runtime_env blob missing from KV: {uri}")
    tmp = cache.with_name(cache.name + f".tmp{os.getpid()}")
    tmp.mkdir(parents=True, exist_ok=True)
    with zipfile.ZipFile(io.BytesIO(raw)) as zf:
        zf.extractall(tmp)
    try:
        tmp.rename(cache)  # atomic publish; losers clean up
    except OSError:
        import shutil
        shutil.rmtree(tmp, ignore_errors=True)
    return cache


def _venv_site_packages(venv_dir: Path) -> Path:
    cands = sorted(venv_dir.glob("lib/python*/site-packages"))
    if not cands:
        raise FileNotFoundError(f"no site-packages under {venv_dir}")
    return cands[0]


def ensure_pip_env(pip: List[str], worker) -> Path:
    """Create-or-reuse the venv for this requirement set; returns its
    site-packages dir.

    venv per sha256(requirements) under ``<cache>/runtime_env/venvs``
    (reference: per-job cached pip environments created by the runtime-env
    agent).  Creation runs under an flock so pooled workers racing on
    first use build it once; the venv uses --system-site-packages (jax and
    the baked-in stack stay importable) and installs with --no-index
    (zero-egress: local wheels via the KV; index requirements fail
    loudly)."""
    import fcntl
    import subprocess

    spec = sorted(str(r) for r in pip)
    digest = hashlib.sha256("\n".join(spec).encode()).hexdigest()[:16]
    venv_root = _env_cache_root(worker) / "runtime_env" / "venvs"
    venv_dir = venv_root / digest
    if venv_dir.exists():
        return _venv_site_packages(venv_dir)
    venv_root.mkdir(parents=True, exist_ok=True)
    lock_path = venv_root / f".{digest}.lock"
    with open(lock_path, "w") as lock_f:
        fcntl.flock(lock_f, fcntl.LOCK_EX)
        if venv_dir.exists():  # lost the race: winner built it
            return _venv_site_packages(venv_dir)
        # materialize KV wheels (filename preserved — pip reads wheel
        # metadata from it)
        wheel_dir = venv_root / f".{digest}.wheels"
        wheel_dir.mkdir(exist_ok=True)
        install_args = []
        for req in spec:
            if req.startswith(_WHL_PREFIX):
                blob_id, _, fname = req[len(_WHL_PREFIX):].partition("/")
                raw = worker.rpc("kv_get",
                                 key=f"runtime_env/{blob_id}").get("value")
                if raw is None:
                    raise FileNotFoundError(
                        f"runtime_env wheel missing from KV: {req}")
                wheel_path = wheel_dir / fname
                wheel_path.write_bytes(raw)
                install_args.append(str(wheel_path))
            else:
                install_args.append(req)
        tmp = venv_root / f".{digest}.tmp"
        import shutil
        shutil.rmtree(tmp, ignore_errors=True)
        import venv as venv_mod
        venv_mod.create(tmp, system_site_packages=True, with_pip=True,
                        symlinks=True)
        proc = subprocess.run(
            [str(tmp / "bin" / "python"), "-m", "pip", "install",
             "--no-index", "--quiet", *install_args],
            capture_output=True, text=True)
        if proc.returncode != 0:
            shutil.rmtree(tmp, ignore_errors=True)
            shutil.rmtree(wheel_dir, ignore_errors=True)
            raise RuntimeError(
                f"pip runtime_env install failed (--no-index; only local/"
                f"KV wheels resolve in this zero-egress build): "
                f"{proc.stderr[-800:]}")
        os.rename(tmp, venv_dir)  # atomic publish under the lock
        shutil.rmtree(wheel_dir, ignore_errors=True)
    return _venv_site_packages(venv_dir)


def _resolve_existing_conda_env(exe: str, name_or_prefix: str) -> Path:
    """Ray's string form names an EXISTING env (by name or prefix path)."""
    import json as json_mod
    import subprocess

    p = Path(name_or_prefix).expanduser()
    if os.sep in name_or_prefix or p.is_dir():
        if not p.is_dir():
            raise FileNotFoundError(
                f"conda env prefix does not exist: {name_or_prefix}")
        return p
    proc = subprocess.run([exe, "env", "list", "--json"],
                          capture_output=True, text=True)
    if proc.returncode == 0:
        try:
            for env_path in json_mod.loads(proc.stdout).get("envs", []):
                if Path(env_path).name == name_or_prefix:
                    return Path(env_path)
        except ValueError:
            pass
    raise FileNotFoundError(
        f"conda env {name_or_prefix!r} not found (conda env list)")


def ensure_conda_env(spec: Any, worker) -> Path:
    """Create-or-reuse a conda env for this spec; returns the env prefix.

    Spec forms (reference conda plugin semantics):
    - str: the NAME or PREFIX of an existing env — used as-is, never
      created;
    - list of package strings, or a dict in the environment.yml subset
      {"dependencies": [... , {"pip": [...]}], "channels": [...]}:
      created with the same cache discipline as pip (one env per
      sha256(canonical spec incl. channels) under
      ``<cache>/runtime_env/conda``, built once under an flock,
      atomically published via rename); nested pip deps install into the
      env's own python afterwards."""
    import fcntl
    import shutil
    import subprocess

    exe = _conda_exe()
    if exe is None:
        raise RuntimeError("no conda/mamba binary on PATH")
    if isinstance(spec, str):
        return _resolve_existing_conda_env(exe, spec)
    channels: List[str] = []
    pip_deps: List[str] = []
    if isinstance(spec, dict):
        channels = [str(c) for c in spec.get("channels", [])]
        deps = []
        for d in spec.get("dependencies", []):
            if isinstance(d, dict):
                pip_deps += [str(x) for x in d.get("pip", [])]
            else:
                deps.append(str(d))
    else:
        deps = [str(d) for d in spec]
    deps = sorted(deps)
    pip_deps = sorted(pip_deps)
    canonical = "\n".join(["C:" + c for c in channels] + deps +
                          ["P:" + p for p in pip_deps])
    digest = hashlib.sha256(canonical.encode()).hexdigest()[:16]
    root = _env_cache_root(worker) / "runtime_env" / "conda"
    env_dir = root / digest
    if env_dir.exists():
        return env_dir
    root.mkdir(parents=True, exist_ok=True)
    with open(root / f".{digest}.lock", "w") as lock_f:
        fcntl.flock(lock_f, fcntl.LOCK_EX)
        if env_dir.exists():
            return env_dir
        tmp = root / f".{digest}.tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        chan_flags = [f for c in channels for f in ("-c", c)]
        proc = subprocess.run(
            [exe, "create", "-y", "-p", str(tmp), *chan_flags, *deps],
            capture_output=True, text=True)
        if proc.returncode != 0:
            shutil.rmtree(tmp, ignore_errors=True)
            raise RuntimeError(
                f"conda runtime_env create failed: {proc.stderr[-800:]}")
        if pip_deps:
            env_py = tmp / "bin" / "python"
            pip_cmd = [str(env_py) if env_py.exists() else sys.executable,
                       "-m", "pip", "install", "--no-index", *pip_deps]
            proc = subprocess.run(pip_cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                shutil.rmtree(tmp, ignore_errors=True)
                raise RuntimeError(
                    f"conda runtime_env pip section failed (--no-index; "
                    f"zero-egress build): {proc.stderr[-800:]}")
        os.rename(tmp, env_dir)  # atomic publish under the lock
    return env_dir


_CONTAINER_BOOTSTRAP = (
    "import pickle,sys,traceback\n"
    "fn,a,k=pickle.load(open('/rtt_io/in.pkl','rb'))\n"
    "try:\n"
    "    out=(True,fn(*a,**k))\n"
    "except BaseException as e:\n"
    "    out=(False,e)\n"
    "pickle.dump(out,open('/rtt_io/out.pkl','wb'))\n")


def run_in_container(container: Any, fn, args, kwargs, worker) -> Any:
    """Per-task exec prefix (reference: the container runtime-env plugin
    runs the worker inside the image).  The task body ships as a pickle
    through a bind-mounted scratch dir; the container runs a one-shot
    bootstrap and pickles back (ok, result | exception)."""
    import pickle
    import subprocess
    import tempfile

    import cloudpickle

    exe = _container_exe()
    if exe is None:
        raise RuntimeError("no podman/docker binary on PATH")
    if isinstance(container, str):
        image, run_options = container, []
    else:
        image = container["image"]
        run_options = [str(o) for o in container.get("run_options", [])]
    with tempfile.TemporaryDirectory(prefix="rtt_ctr_") as td:
        (Path(td) / "in.pkl").write_bytes(
            cloudpickle.dumps((fn, args, kwargs)))
        cmd = [exe, "run", "--rm", "-v", f"{td}:/rtt_io", *run_options,
               image, "python", "-c", _CONTAINER_BOOTSTRAP]
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=float(os.environ.get(
                                  "RTT_CONTAINER_TASK_TIMEOUT", 3600)))
        out_path = Path(td) / "out.pkl"
        if proc.returncode != 0 or not out_path.exists():
            raise RuntimeError(
                f"container task failed (rc={proc.returncode}): "
                f"{proc.stderr[-800:]}")
        ok, payload = pickle.loads(out_path.read_bytes())
    if ok:
        return payload
    raise payload


def apply(runtime_env: Optional[dict], worker) -> Dict[str, Any]:
    """Apply working_dir/py_modules/env_vars; returns restore state.

    Exception-safe: a failure mid-application (missing KV blob, corrupt
    zip) restores whatever was already applied before re-raising, so the
    pooled worker process is left clean for the next task."""
    saved: Dict[str, Any] = {"env": {}, "cwd": None, "sys_path": [],
                             "module_prefixes": []}
    if not runtime_env:
        return saved
    try:
        for k, v in (runtime_env.get("env_vars") or {}).items():
            saved["env"][k] = os.environ.get(k)
            os.environ[k] = str(v)
        pip = runtime_env.get("pip")
        if pip:
            site = ensure_pip_env([pip] if isinstance(pip, str) else pip,
                                  worker)
            sys.path.insert(0, str(site))
            saved["sys_path"].append(str(site))
            # restore() purges modules imported from here so the pooled
            # worker's import state is not polluted for the next task
            saved["module_prefixes"].append(str(site))
        conda = runtime_env.get("conda")
        if conda:
            env_dir = ensure_conda_env(conda, worker)
            # in-process application mirrors the pip plugin: the env's
            # site-packages prefixes sys.path (python-version-compatible
            # packages), its bin prefixes PATH for subprocess tools;
            # module purge keeps the pooled worker clean
            for sp in sorted(env_dir.glob("lib/python*/site-packages")):
                sys.path.insert(0, str(sp))
                saved["sys_path"].append(str(sp))
                saved["module_prefixes"].append(str(sp))
            saved["env"].setdefault("PATH", os.environ.get("PATH"))
            os.environ["PATH"] = f"{env_dir / 'bin'}:" + \
                os.environ.get("PATH", "")
        wd = runtime_env.get("working_dir")
        if wd:
            local = ensure_local(wd, worker)
            saved["cwd"] = os.getcwd()
            os.chdir(local)
            sys.path.insert(0, str(local))
            saved["sys_path"].append(str(local))
        for m in (runtime_env.get("py_modules") or []):
            local = ensure_local(m, worker)
            sys.path.insert(0, str(local))
            saved["sys_path"].append(str(local))
    except BaseException:
        restore(saved)
        raise
    return saved


def restore(saved: Dict[str, Any]) -> None:
    for k, v in saved.get("env", {}).items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    if saved.get("cwd"):
        try:
            os.chdir(saved["cwd"])
        except OSError:
            pass
    for p in saved.get("sys_path", []):
        try:
            sys.path.remove(p)
        except ValueError:
            pass
    prefixes = tuple(saved.get("module_prefixes") or ())
    if prefixes:
        for name, mod in list(sys.modules.items()):
            f = getattr(mod, "__file__", None)
            if f and f.startswith(prefixes):
                del sys.modules[name]
