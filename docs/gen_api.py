"""Generate docs/api.md — the API reference — from the package docstrings.

The reference ships Documenter autodocs built in CI
(/root/reference/docs/src/lib/*.md, .github/workflows/CI.yml:76-99); this
is the equivalent for this framework: every public module, class,
function, and method is rendered with its live signature and docstring, so
the committed artifact can never describe an API that does not exist.
CI regenerates api.md and fails if it differs from the committed copy
(tests/test_benchdoc.py::test_api_reference_in_sync).

Usage: python docs/gen_api.py [--check]
"""

from __future__ import annotations

import inspect
import os
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

API_MD = os.path.join(REPO, "docs", "api.md")

# (module, one-line role) in presentation order: user-facing first,
# internals last.  Only symbols DEFINED in the module are documented.
MODULES = [
    ("mcintegration", "package root — the public API surface"),
    ("mcintegration.main", "the integrate() driver and kernel cache"),
    ("mcintegration.configuration", "Configuration (MC state)"),
    ("mcintegration.statistics", "Result, averaging, report tables"),
    ("mcintegration.models.variable",
     "variable pools: Continuous / Discrete / FermiK / CompositeVar"),
    ("mcintegration.checkpoint", "trained-state save/load"),
    ("mcintegration.parallel.mesh",
     "device meshes, distributed init, collectives"),
    ("mcintegration.common", "constants and the onehot measure helper"),
    ("mcintegration.debug", "debug=True probes and finite guards"),
    ("mcintegration.platform", "entry-point set-up: compile cache"),
    ("mcintegration.solvers.engine",
     "shared solver engine: Spec, pools, padding algebra"),
    ("mcintegration.solvers.vegas", ":vegas iteration kernel"),
    ("mcintegration.solvers.vegasplus", ":vegasplus iteration kernel"),
    ("mcintegration.solvers.vegasmc", ":vegasmc iteration kernel"),
    ("mcintegration.solvers.mcmc", ":mcmc iteration kernel"),
    ("mcintegration.ops.grid",
     "adaptive Vegas-map math: smooth / rescale / train"),
    ("mcintegration.ops.lookup", "two-level table lookup primitives"),
    ("mcintegration.ops.ksum", "Kahan-compensated accumulators"),
    ("mcintegration.ops.pallas_vegas", "fused :vegas Triton kernel"),
    ("mcintegration.ops.pallas_chain", "fused :vegasmc Triton kernel"),
    ("mcintegration.utils.stopwatch", "StopWatch periodic reporting"),
    ("mcintegration.utils.progress", "progress bar"),
    ("mcintegration.utils.color", "ANSI color helpers"),
]


def _sig(obj) -> str:
    try:
        return str(inspect.signature(obj))
    except (ValueError, TypeError):
        return "(...)"


def _doc(obj, indent: str = "") -> str:
    doc = inspect.getdoc(obj)
    if not doc:
        return ""
    return textwrap.indent(doc, indent)


def _public_members(mod):
    """(classes, functions) defined in `mod`, in source order."""
    classes, functions = [], []
    for name, obj in vars(mod).items():
        if name.startswith("_"):
            continue
        if getattr(obj, "__module__", None) != mod.__name__:
            continue
        try:
            _, line = inspect.getsourcelines(obj)
        except (OSError, TypeError):
            line = 0
        if inspect.isclass(obj):
            classes.append((line, name, obj))
        elif inspect.isfunction(obj):
            functions.append((line, name, obj))
    return sorted(classes), sorted(functions)


def render() -> str:
    import importlib

    L = []
    A = L.append
    A("<!-- GENERATED by `python docs/gen_api.py`. Do not edit by hand: "
      "CI and tests/test_benchdoc.py verify this file matches the live "
      "docstrings. -->")
    A("")
    A("# API reference")
    A("")
    A("Generated from the package docstrings (the analogue of the "
      "reference's Documenter autodocs, docs/src/lib/*.md).  Docstrings "
      "cite the corresponding reference implementation as `file.jl:lines` "
      "for parity checking.")
    A("")
    A("## Contents")
    A("")
    for mod_name, role in MODULES:
        anchor = mod_name.replace(".", "")
        A(f"- [`{mod_name}`](#{anchor}) — {role}")
    A("")
    for mod_name, role in MODULES:
        mod = importlib.import_module(mod_name)
        A(f'<a name="{mod_name.replace(".", "")}"></a>')
        A(f"## `{mod_name}`")
        A("")
        mdoc = _doc(mod)
        if mdoc:
            A(mdoc)
            A("")
        classes, functions = _public_members(mod)
        for _, name, cls in classes:
            A(f"### class `{name}{_sig(cls)}`")
            A("")
            cdoc = _doc(cls)
            if cdoc:
                A(cdoc)
                A("")
            for mname, meth in sorted(vars(cls).items()):
                if mname.startswith("_") or not inspect.isfunction(meth):
                    continue
                A(f"- **`{mname}{_sig(meth)}`**")
                mdoc_ = _doc(meth, "  ")
                if mdoc_:
                    A("")
                    A(mdoc_)
                A("")
        for _, name, fn in functions:
            A(f"### `{name}{_sig(fn)}`")
            A("")
            fdoc = _doc(fn)
            if fdoc:
                A(fdoc)
                A("")
    return "\n".join(L) + "\n"


def main():
    md = render()
    if "--check" in sys.argv:
        current = open(API_MD).read() if os.path.exists(API_MD) else ""
        if current != md:
            print("docs/api.md is out of date — run `python docs/gen_api.py`")
            sys.exit(1)
        print("docs/api.md is in sync")
        return
    open(API_MD, "w").write(md)
    print(f"wrote {API_MD} ({len(md.splitlines())} lines)")


if __name__ == "__main__":
    main()
