"""The port's counterpart of the JAX package's ``tests/test_analysis.py``
(its static half and the ``_AsyncRegen`` ride-along), plus the port lint's
parity with the JAX lint and its CLI.

* the repo gate — every lint pass of
  ``partiallyshuffledistributedsampler_tpu_torch.analysis.lint`` over the
  port package must report zero findings (the bar ``make analyze-torch``
  enforces);
* the golden snippets and planted-fault trees of the JAX file, against the
  port's lint, with the trees built under the port's package name;
* parity: on equal inputs the port's lint and the JAX lint return equal
  findings, pass by pass;
* the CLI in a subprocess: exit codes, output lines, and no ``jax`` and
  nothing of the JAX package loaded;
* the ride-along: ``load_state_dict`` joins a pending host prefetch.

The runtime sanitizer's cases are in ``tests/test_torch_port_faults.py``
and the suites that run under ``PSDS_SANITIZE=1``.
"""

from __future__ import annotations

import ast
import json
import pathlib
import subprocess
import sys
import textwrap

import pytest

from partiallyshuffledistributedsampler_tpu.analysis import lint as jlint
from partiallyshuffledistributedsampler_tpu_torch.analysis import lint
from partiallyshuffledistributedsampler_tpu_torch.analysis.lint import (
    PASSES,
    check_clocks,
    check_guarded_by,
    check_silent_except,
    default_root,
    doc_metric_tokens,
    lint_fault_sites,
    lint_metrics_docs,
    lint_protocol,
    run_all,
)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = "partiallyshuffledistributedsampler_tpu_torch"
JAX_PKG = "partiallyshuffledistributedsampler_tpu"
_JAX_SIDE = ("jax", "jaxlib", "flax", "optax", JAX_PKG)


def _src(text: str) -> str:
    return textwrap.dedent(text)


def _mini_repo(root, files):
    for rel, text in files.items():
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(text), encoding="utf-8")
    return root


# --------------------------------------------------------------- repo gate
def test_default_root_is_the_repo_and_pkg_is_the_port():
    assert default_root() == ROOT
    assert lint._PKG == PKG
    assert (default_root() / lint._PKG / "analysis" / "lint.py").is_file()


@pytest.mark.parametrize("name", sorted(PASSES))
def test_repo_has_zero_findings(name):
    findings = PASSES[name](default_root())
    assert not findings, "\n".join(f.render() for f in findings)


def test_run_all_rejects_unknown_pass():
    with pytest.raises(ValueError):
        run_all(default_root(), ["no-such-pass"])


def test_package_exports_the_static_half():
    from partiallyshuffledistributedsampler_tpu_torch import analysis

    assert analysis.Finding is lint.Finding
    assert analysis.run_all is lint.run_all
    assert sorted(analysis.__all__) == sorted(
        ["Finding", "run_all", "lockorder", "new_lock"])


# ----------------------------------------------------- guarded-by golden
_GUARDED_BAD = """
    import threading

    class C:
        def __init__(self):
            self._lock = threading.Lock()
            self.x = 0  # guarded by: self._lock

        def bad(self):
            return self.x
"""

_GUARDED_GOOD = """
    import threading

    class C:
        def __init__(self):
            self._lock = threading.Lock()
            self.x = 0  # guarded by: self._lock

        def good(self):
            with self._lock:
                return self.x

        def _read_locked(self):
            return self.x
"""

_GUARDED_COND = """
    import threading

    class C:
        def __init__(self):
            self._lock = threading.Lock()
            self._cond = threading.Condition(self._lock)
            self.x = 0  # guarded by: self._lock

        def good(self):
            with self._cond:
                self.x += 1
"""

_GUARDED_WAIVER = """
    import threading

    class C:
        def __init__(self):
            self._lock = threading.Lock()
            self.x = 0  # guarded by: self._lock

        def racy(self):
            return self.x  # lint: allow-unguarded(%s)
"""


def test_guarded_by_flags_unlocked_access():
    findings = check_guarded_by(_src(_GUARDED_BAD), "snippet.py")
    assert len(findings) == 1
    assert "C.bad" in findings[0].message and "self.x" in findings[0].message


def test_guarded_by_accepts_with_lock_and_locked_suffix():
    assert check_guarded_by(_src(_GUARDED_GOOD), "snippet.py") == []


def test_guarded_by_condition_aliases_its_lock():
    assert check_guarded_by(_src(_GUARDED_COND), "snippet.py") == []


def test_guarded_by_waiver_needs_a_reason():
    assert check_guarded_by(
        _src(_GUARDED_WAIVER % "monotonic flag, stale read ok"),
        "snippet.py") == []
    findings = check_guarded_by(_src(_GUARDED_WAIVER % ""), "snippet.py")
    assert len(findings) == 1
    assert "needs a reason" in findings[0].message


# --------------------------------------------------------- clocks golden
_WALLCLOCK = """
    import time

    def stamp(%s):
        return time.time()
"""

_DATETIME_NOW = """
    import datetime

    def stamp(clock=None):
        return datetime.datetime.now()
"""

_WALLCLOCK_WAIVED = """
    import time

    def stamp(clock=None):
        return time.time()  # lint: allow-wallclock(log line only)
"""


def test_clocks_only_applies_to_injectable_modules():
    # no clock= parameter anywhere: wall clock is fine
    assert check_clocks(_src(_WALLCLOCK % ""), "snippet.py") == []
    # an injectable module must route through the injected clock
    findings = check_clocks(_src(_WALLCLOCK % "clock=time.time"),
                            "snippet.py")
    assert len(findings) == 1
    assert "injectable clock=" in findings[0].message


def test_clocks_flags_datetime_now_and_accepts_waiver():
    assert len(check_clocks(_src(_DATETIME_NOW), "snippet.py")) == 1
    assert check_clocks(_src(_WALLCLOCK_WAIVED), "snippet.py") == []


# ------------------------------------------------- silent-except golden
_BARE_PASS = """
    def f():
        try:
            work()
        except Exception:
            pass
"""

_HANDLED = """
    def f():
        try:
            work()
        except Exception as exc:
            {body}
"""

_HANDLED_BODIES = [
    "raise",                       # re-raise
    "metrics.inc('errors')",       # counter bump
    "log(exc)",                    # the exception is used
]

_IMPORT_GUARD = """
    try:
        import torch
        HAVE_TORCH = True
    except Exception:
        HAVE_TORCH = False
"""

_ASSIGN_ONLY = """
    def f(exc, ids):
        try:
            exc.tag = ids
        except Exception:
            pass
"""

_EXCEPT_WAIVER = """
    def f():
        try:
            work()
        except Exception:  # lint: allow-broad-except(%s)
            pass
"""


def test_silent_except_flags_bare_pass():
    assert len(check_silent_except(_src(_BARE_PASS), "snippet.py")) == 1


@pytest.mark.parametrize("body", _HANDLED_BODIES)
def test_silent_except_accepts_handled_errors(body):
    findings = check_silent_except(_src(_HANDLED.format(body=body)),
                                   "snippet.py")
    assert findings == []


def test_silent_except_import_guard_exempt_but_not_assign_only():
    assert check_silent_except(_src(_IMPORT_GUARD), "snippet.py") == []
    # a try body with no import is NOT an import guard
    assert len(check_silent_except(_src(_ASSIGN_ONLY), "snippet.py")) == 1


def test_silent_except_waiver_and_empty_reason():
    assert check_silent_except(_src(_EXCEPT_WAIVER % "best effort"),
                               "snippet.py") == []
    findings = check_silent_except(_src(_EXCEPT_WAIVER % ""), "snippet.py")
    assert len(findings) == 1
    assert "needs a reason" in findings[0].message


# --------------------------------------------- fault-sites golden (tmp repo)
def _fault_sites_files(pkg):
    return {
        f"{pkg}/faults/plan.py": """
            SITES = frozenset({"net.send", "never.drawn"})
        """,
        f"{pkg}/mod.py": """
            def f(F):
                F.draw("net.send")
                F.fire("not.registered")
        """,
    }


def test_fault_sites_drift_both_directions(tmp_path):
    root = _mini_repo(tmp_path, _fault_sites_files(lint._PKG))
    findings = lint_fault_sites(root)
    msgs = [f.message for f in findings]
    assert len(findings) == 2
    assert any("'not.registered'" in m and "absent from" in m for m in msgs)
    assert any("'never.drawn'" in m and "no code draws" in m for m in msgs)


# ------------------------------------------------ protocol golden (tmp repo)
def _protocol_files(pkg):
    return {
        f"{pkg}/service/protocol.py": """
            MSG_PING = 1
            MSG_PONG = 2
            MSG_DEAD = 3
        """,
        f"{pkg}/service/server.py": """
            from . import protocol as P

            def serve(sock, msg):
                if msg == P.MSG_PING:
                    P.send_msg(sock, P.MSG_PONG, {"code": "weird_code"})
        """,
        f"{pkg}/service/client.py": """
            from . import protocol as P

            HANDLED = ("ok_code",)
            _PING, _PONG = P.MSG_PING, P.MSG_PONG
        """,
        f"{pkg}/service/replication.py": """
            # no error-code handling here
        """,
    }


def test_protocol_dead_opcode_and_unhandled_error_code(tmp_path):
    root = _mini_repo(tmp_path, _protocol_files(lint._PKG))
    findings = lint_protocol(root)
    msgs = [f.message for f in findings]
    assert any("MSG_DEAD" in m and "dead opcode" in m for m in msgs)
    assert any("MSG_DEAD" in m and "no server dispatch arm" in m
               for m in msgs)
    assert any("'weird_code'" in m for m in msgs)
    assert not any("MSG_PING" in m or "MSG_PONG" in m for m in msgs)


# -------------------------------------------- metrics-docs golden (tmp repo)
_DOC_CONTEXT = """
    The `epoch_regen_ms` timer tracks regen latency.

    This paragraph mentions `some_kwarg` but no metric words.
"""


def test_doc_metric_tokens_need_metric_context():
    tokens = doc_metric_tokens(_src(_DOC_CONTEXT))
    assert "epoch_regen_ms" in tokens
    assert "some_kwarg" not in tokens


def _metrics_docs_files(pkg):
    return {
        f"{pkg}/mod.py": """
            def f(registry):
                registry.inc("hits_total")
        """,
        "docs/GOOD.md": """
            The `hits_total` counter counts hits.
        """,
        "docs/BAD.md": """
            The `missing_total` counter does not exist in code.
        """,
    }


def test_metrics_docs_drift(tmp_path):
    root = _mini_repo(tmp_path, _metrics_docs_files(lint._PKG))
    findings = lint_metrics_docs(root)
    assert len(findings) == 1
    assert findings[0].path == "docs/BAD.md"
    assert "`missing_total`" in findings[0].message


def test_kernel_launch_counter_names_are_not_metric_names(tmp_path):
    """The ``._count(...)`` clause of metrics-docs matches method calls
    only: the WAL's ``self._count(...)`` names are metric names, and the
    kernel launch counter, a plain ``_count(...)`` call in
    ``ops/cuda_kernel.py``, adds none, in either lint."""
    kernels = {"mixture_fused", "mixture_fused_wide", "mixture_source_keys",
               "shard_row_keys", "shard_expand"}
    src = (ROOT / PKG / "ops" / "cuda_kernel.py").read_text(encoding="utf-8")
    assert all(f'_count("{k}")' in src for k in kernels)
    names = lint._code_metric_names(default_root())
    assert {"wal_appends", "wal_append_errors"} <= names
    assert not kernels & names
    body = """
        def f(self):
            self._count("wal_like_total")
            _count("kernel_like")
    """
    ours = lint._code_metric_names(_mini_repo(tmp_path / "port",
                                              {f"{PKG}/m.py": body}))
    theirs = jlint._code_metric_names(_mini_repo(tmp_path / "jax",
                                                 {f"{JAX_PKG}/m.py": body}))
    assert ours == theirs == {"wal_like_total"}


# ------------------------------------------------- parity with the JAX lint
_SNIPPETS = (
    [_GUARDED_BAD, _GUARDED_GOOD, _GUARDED_COND,
     _GUARDED_WAIVER % "monotonic flag, stale read ok", _GUARDED_WAIVER % "",
     _WALLCLOCK % "", _WALLCLOCK % "clock=time.time", _DATETIME_NOW,
     _WALLCLOCK_WAIVED, _BARE_PASS, _IMPORT_GUARD, _ASSIGN_ONLY,
     _EXCEPT_WAIVER % "best effort", _EXCEPT_WAIVER % ""]
    + [_HANDLED.format(body=b) for b in _HANDLED_BODIES])

_SOURCE_CHECKS = {
    "guarded-by": "check_guarded_by",
    "clocks": "check_clocks",
    "silent-except": "check_silent_except",
}


def _planted_files(pkg):
    """One planted fault (or more) for every pass, under ``pkg``."""
    files = {}
    files.update(_fault_sites_files(pkg))
    files.update(_protocol_files(pkg))
    files.update(_metrics_docs_files(pkg))
    files[f"{pkg}/mod.py"] = """
        def f(F, registry):
            F.draw("net.send")
            F.fire("not.registered")
            registry.inc("hits_total")
    """
    files[f"{pkg}/guarded.py"] = _GUARDED_BAD
    files[f"{pkg}/clocked.py"] = _DATETIME_NOW
    files[f"{pkg}/silent.py"] = _BARE_PASS
    files[f"{pkg}/sharding/plane.py"] = """
        def refuse(sock, P):
            P.send_msg(sock, P.MSG_PONG, {"code": "shard_weird"})
    """
    return files


def _findings(findings, pkg):
    """Findings as tuples, with the package prefix of each path mapped
    to a common placeholder."""
    return [(f.pass_id, f.path.replace(pkg, "PKG", 1), f.line, f.message)
            for f in findings]


def test_passthrough_sets_and_passes_equal_the_jax_lint():
    assert lint._ERROR_CODE_PASSTHROUGH == jlint._ERROR_CODE_PASSTHROUGH
    assert lint._DOC_TOKEN_PASSTHROUGH == jlint._DOC_TOKEN_PASSTHROUGH
    assert list(PASSES) == list(jlint.PASSES)
    assert jlint._PKG == JAX_PKG


@pytest.mark.parametrize("name", sorted(PASSES))
def test_parity_with_the_jax_lint(name, tmp_path):
    # 1. the per-source checks on every module of both packages and on
    #    every golden snippet
    if name in _SOURCE_CHECKS:
        ours = getattr(lint, _SOURCE_CHECKS[name])
        theirs = getattr(jlint, _SOURCE_CHECKS[name])
        sources = [(s, f"snippet{i}.py") for i, s in
                   enumerate(_src(t) for t in _SNIPPETS)]
        for pkg in (PKG, JAX_PKG):
            sources += [(p.read_text(encoding="utf-8"),
                         str(p.relative_to(ROOT)))
                        for p in sorted((ROOT / pkg).rglob("*.py"))]
        assert len(sources) > 200
        for text, path in sources:
            assert ([f.__dict__ for f in ours(text, path)]
                    == [f.__dict__ for f in theirs(text, path)]), path
    # 2. the doc tokenizer on every doc of the repo
    if name == "metrics-docs":
        docs = sorted((ROOT / "docs").glob("*.md"))
        assert docs
        for doc in docs:
            text = doc.read_text(encoding="utf-8")
            assert doc_metric_tokens(text) == jlint.doc_metric_tokens(text)
    # 3. the same planted faults under each package's name
    ours_root = _mini_repo(tmp_path / "port", _planted_files(PKG))
    theirs_root = _mini_repo(tmp_path / "jax", _planted_files(JAX_PKG))
    ours = _findings(run_all(ours_root, [name]), PKG)
    theirs = _findings(jlint.run_all(theirs_root, [name]), JAX_PKG)
    assert ours, f"no planted fault caught by {name}"
    assert ours == theirs


# ------------------------------------------------------------------- CLI
def _cli(*args, cwd=ROOT):
    return subprocess.run(
        [sys.executable, "-m", f"{PKG}.analysis", *args], cwd=cwd,
        capture_output=True, text=True, timeout=300)


def test_cli_on_the_repo_exits_zero():
    res = _cli()
    assert res.returncode == 0, res.stdout + res.stderr
    last = res.stdout.strip().splitlines()[-1]
    assert last.startswith("analysis: 0 finding(s) [")
    assert last.endswith(f"over {ROOT}")
    res = _cli("--json", "--root", str(ROOT))
    assert res.returncode == 0, res.stdout + res.stderr
    assert json.loads(res.stdout) == []


def test_cli_exits_one_on_a_planted_finding(tmp_path):
    root = _mini_repo(tmp_path, {
        f"{PKG}/faults/plan.py": "SITES = frozenset()\n",
        f"{PKG}/service/protocol.py": "\n",
        f"{PKG}/service/server.py": "\n",
        f"{PKG}/service/client.py": "\n",
        f"{PKG}/service/replication.py": "\n",
        f"{PKG}/mod.py": _BARE_PASS,
    })
    res = _cli("--root", str(root))
    assert res.returncode == 1, res.stdout + res.stderr
    lines = res.stdout.strip().splitlines()
    assert lines[0].startswith(f"{PKG}/mod.py:5: [silent-except] broad ")
    assert lines[-1].startswith("analysis: 1 finding(s) [")
    res = _cli("--root", str(root), "--json", "--pass", "silent-except")
    assert res.returncode == 1, res.stdout + res.stderr
    assert json.loads(res.stdout) == [{
        "pass_id": "silent-except", "path": f"{PKG}/mod.py", "line": 5,
        "message": check_silent_except(_src(_BARE_PASS), "x")[0].message}]
    res = _cli("--root", str(root), "--pass", "clocks")
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.strip() == f"analysis: 0 finding(s) [clocks] over {root}"


def test_cli_pass_choices_equal_the_jax_cli(capsys):
    from partiallyshuffledistributedsampler_tpu.analysis import (
        __main__ as jmain,
    )
    from partiallyshuffledistributedsampler_tpu_torch.analysis import (
        __main__ as main,
    )

    errors = []
    for mod in (main, jmain):
        with pytest.raises(SystemExit) as exc:
            mod.main(["--pass", "no-such-pass"])
        assert exc.value.code == 2
        err = capsys.readouterr().err
        errors.append(err[err.index("--pass: invalid choice"):])
    assert errors[0] == errors[1]
    assert all(p in errors[0] for p in PASSES)


def test_cli_loads_no_jax():
    code = (
        "import runpy, sys\n"
        f"sys.argv = ['analysis', '--pass', 'metrics-docs']\n"
        "try:\n"
        f"    runpy.run_module('{PKG}.analysis', run_name='__main__')\n"
        "except SystemExit as exc:\n"
        "    rc = exc.code\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {_JAX_SIDE!r}]\n"
        "print('RC', rc, 'BAD', bad)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.strip().splitlines()[-1] == "RC 0 BAD []"


@pytest.mark.parametrize("module", ["lint.py", "__main__.py"])
def test_lint_modules_import_only_the_standard_library(module):
    tree = ast.parse((ROOT / PKG / "analysis" / module).read_text(
        encoding="utf-8"))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops = [a.name.split(".")[0] for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                # only the sibling lint module, inside analysis/
                assert node.level == 1 and node.module == "lint", \
                    ast.dump(node)
                continue
            tops = [node.module.split(".")[0]]
        else:
            continue
        for top in tops:
            assert top in sys.stdlib_module_names, (module, top)


# ------------------------------------------------- _AsyncRegen ride-along
def test_load_state_dict_joins_pending_regen():
    from partiallyshuffledistributedsampler_tpu_torch import (
        PartiallyShuffleDistributedSampler,
    )
    from partiallyshuffledistributedsampler_tpu_torch.sampler.torch_shim import (
        _AsyncRegen,
    )

    s = PartiallyShuffleDistributedSampler(
        1000, num_replicas=2, rank=0, window=64, backend="cpu")
    s.set_epoch(1)
    pending = s._pending
    assert isinstance(pending, _AsyncRegen)
    s.load_state_dict(s.state_dict())
    # the abandoned prefetch worker was joined, not leaked
    assert not pending._t.is_alive()
    assert s._pending is None
    assert list(s)  # the sampler still serves the restored epoch


def test_mixture_load_state_dict_joins_pending_regen():
    from partiallyshuffledistributedsampler_tpu_torch.sampler.mixture import (
        PartialShuffleMixtureSampler,
    )
    from partiallyshuffledistributedsampler_tpu_torch.sampler.torch_shim import (
        _AsyncRegen,
    )

    s = PartialShuffleMixtureSampler(
        [100, 200, 50], [5, 3, 2], num_replicas=2, rank=0, block=16,
        backend="cpu")
    s.set_epoch(1)
    pending = s._pending
    assert isinstance(pending, _AsyncRegen)
    s.load_state_dict(s.state_dict())
    assert not pending._t.is_alive()
    assert s._pending is None
    assert list(s)
