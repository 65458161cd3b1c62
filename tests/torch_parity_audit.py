"""Parity audit: the JAX package's own tests, pointed at the port.

Copies the checkout into OUT (default `.scratch/parity_audit` in the
checkout, which git ignores), rewrites `filodb_tpu` to
`filodb_tpu_torch` in every file under the copy's `tests/` that is not
one of the port's own (`test_torch_*`, `torch_*`), rewrites their
`import jax.numpy as jnp` (at any indentation) to a shim module written
into the copy, whose `asarray` and `array` give torch tensors of the
numpy array, makes the copy's conftest resolve every device to the CPU,
and runs the rewritten test files there with the tier-1 xdist flags.
The tests run in the copy with TMPDIR under OUT and bytecode caches
off, so nothing is written outside OUT.

    python tests/torch_parity_audit.py [--out DIR] [-n 6]
        [--timeout 1200] [FILE_OR_NODEID ...]

It prints one line per test file (passed, failed, errors, skipped), the
totals as a JSON line, and writes the failing node ids to
OUT/failures.txt and the pytest log to OUT/audit.log.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import xml.etree.ElementTree as ET
from collections import Counter, defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
_NAME = re.compile(r"\bfilodb_tpu\b")
_JNP = re.compile(r"^([ \t]*)import jax\.numpy as jnp[ \t]*$", re.M)
_JNP_SHIM = "_parity_audit_jnp"
_JNP_SHIM_SOURCE = '''"""jax.numpy's array constructors, as the parity audit
gives them to the reference's tests: torch tensors of the numpy array."""
import numpy as np
import torch


def asarray(a, dtype=None):
    return torch.as_tensor(np.asarray(a, dtype=dtype))


array = asarray
'''


def _ignored_dirs() -> set:
    """Top-level directories that `.gitignore` lists (`name/`): run
    outputs, caches and the scratch area."""
    path = ROOT / ".gitignore"
    lines = path.read_text().split() if path.exists() else []
    return {ln[:-1] for ln in lines
            if ln.endswith("/") and "/" not in ln[:-1] and "*" not in ln}


# not copied: the history and what git ignores at the top level
_SKIP = {".git", ".scratch"} | _ignored_dirs()
_IGNORE = shutil.ignore_patterns("__pycache__", "*.pyc", "build")
_MARK = ".parity_audit"

_FORCE_CPU = '''

# parity audit: every device the port resolves is the CPU
import filodb_tpu_torch.utils.device as _port_device


def _audit_resolve_device(device="cuda"):
    return torch.device("cpu")


_port_device.resolve_device.__code__ = _audit_resolve_device.__code__
'''


def is_port_file(name: str) -> bool:
    return name.startswith("test_torch_") or name.startswith("torch_")


def prepare(out: Path) -> list:
    """Build the rewritten copy under `out` (emptied first, if an earlier
    audit made it); returns the rewritten test files (relative to
    `out`)."""
    if out.exists():
        if any(out.iterdir()) and not (out / _MARK).exists():
            raise SystemExit(f"{out} is not empty and was not made by an "
                             f"audit; give an empty or new --out")
        shutil.rmtree(out)
    out.mkdir(parents=True)
    (out / _MARK).touch()
    for entry in ROOT.iterdir():
        if entry.name in _SKIP:
            continue
        if entry.is_dir():
            shutil.copytree(entry, out / entry.name, ignore=_IGNORE)
        else:
            shutil.copy2(entry, out / entry.name)
    rewritten = []
    for path in sorted((out / "tests").rglob("*.py")):
        if is_port_file(path.name):
            continue
        text = path.read_text()
        new = _NAME.sub("filodb_tpu_torch", text)
        new = _JNP.sub(rf"\1import {_JNP_SHIM} as jnp", new)
        if path.name == "conftest.py" and path.parent == out / "tests":
            new += "\nimport torch\n" + _FORCE_CPU
        if new != text:
            path.write_text(new)
        if path.name.startswith("test_") and path.parent == out / "tests":
            rewritten.append(str(path.relative_to(out)))
    (out / "tests" / f"{_JNP_SHIM}.py").write_text(_JNP_SHIM_SOURCE)
    return rewritten


def summarize(xml_path: Path):
    """(per-file Counter of outcomes, failing node ids) from junit xml."""
    per_file = defaultdict(Counter)
    failing = []
    root = ET.parse(xml_path).getroot()
    for case in root.iter("testcase"):
        cls = case.get("classname", "") or case.get("name", "")
        mod = cls.split(".")[1] if cls.startswith("tests.") else cls
        mod = mod.split(".")[0]
        name = (f"tests/{mod}.py::{case.get('name')}"
                if case.get("classname") else f"tests/{mod}.py")
        kinds = {c.tag for c in case}
        if "error" in kinds:
            outcome = "errors"
        elif "failure" in kinds:
            outcome = "failed"
        elif "skipped" in kinds:
            outcome = "skipped"
        else:
            outcome = "passed"
        per_file[mod][outcome] += 1
        if outcome in ("errors", "failed"):
            failing.append(name)
    return per_file, failing


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(ROOT / ".scratch" / "parity_audit"),
                    help="scratch directory for the copy and the results "
                         "(emptied first)")
    ap.add_argument("-n", "--workers", type=int, default=6)
    ap.add_argument("--timeout", type=int, default=1200)
    ap.add_argument("targets", nargs="*",
                    help="test files or node ids under tests/ (default: "
                         "every rewritten test file)")
    args = ap.parse_args(argv)
    out = Path(args.out).resolve()
    if out == ROOT or out in ROOT.parents or (
            ROOT in out.parents
            and out.relative_to(ROOT).parts[0] not in _SKIP):
        ap.error("--out must neither hold the checkout nor lie in a part "
                 "of it that is copied")
    files = prepare(out)
    targets = args.targets or files
    xml = out / "audit.xml"
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONDONTWRITEBYTECODE="1",
               TMPDIR=str(out / "tmp"), COLUMNS="400")
    (out / "tmp").mkdir(exist_ok=True)
    cmd = [sys.executable, "-m", "pytest", *targets, "-q", "-m", "not slow",
           "--continue-on-collection-errors", "-p", "no:cacheprovider",
           "-p", "no:randomly", "-rfE", f"--junitxml={xml}"]
    if args.workers > 0:
        cmd += ["-p", "xdist", "-n", str(args.workers), "--dist", "loadfile"]
    with open(out / "audit.log", "w") as log:
        rc = subprocess.run(cmd, cwd=out, env=env, stdout=log,
                            stderr=subprocess.STDOUT,
                            timeout=args.timeout).returncode
    per_file, failing = summarize(xml)
    totals = Counter()
    for mod in sorted(per_file):
        c = per_file[mod]
        totals.update(c)
        print(f"{mod}: passed={c['passed']} failed={c['failed']} "
              f"errors={c['errors']} skipped={c['skipped']}")
    (out / "failures.txt").write_text("".join(f + "\n" for f in failing))
    print(json.dumps({"rc": rc, "files": len(per_file), **{
        k: totals[k] for k in ("passed", "failed", "errors", "skipped")}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
