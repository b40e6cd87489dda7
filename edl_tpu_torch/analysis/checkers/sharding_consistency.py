"""EDL003 — mesh axis names must exist on the meshes we build.

An axis-name typo (``ppermute(xs, mesh, "modle")``) or a name no mesh
constructor ever declares does not fail loudly: the port's mesh raises a
``KeyError`` deep inside a rescale, or (worse, for optional axes resolved
via ``present_axes``) silently treats the axis as size 1 and throws away
the parallelism the caller asked for. Consistent sharding across a rescale
starts with a single source of truth for axis names: ``AXIS_ORDER`` in
``edl_tpu_torch/parallel/mesh.py``.

The checker collects axis-name candidates in ``parallel/``, ``models/``
and ``runtime/`` files from:

- string literals (and tuples of them) passed positionally to the axis-
  taking functions of the port's mesh and collective API:
  ``ppermute(xs, mesh, axis)``, ``zero_shard_spec(shape, mesh, axis)``,
  ``Shard(axis, dim)``, ``shard_batch``/``global_batch_size``/
  ``present_axes``/``axis_size``/``axis_index`` and ``ShardedEmbedding``;
- the first argument of the mesh's own lookups by axis name
  (``mesh.group``, ``.axis_size``, ``.axis_index``, ``.slice_ranks``,
  ``.neighbor``, ``.axis``) on a receiver whose name says it is a mesh;
- the keys of dict literals given to ``MeshSpec``/``local_mesh``;
- string defaults of parameters named ``axis``/``*_axis`` (tuple defaults
  for ``*_axes``), including dataclass fields and module constants named
  ``*_AXIS``, and keywords so named at any call.

Every candidate must appear in the declared-axis universe parsed from
``AXIS_ORDER``. Fixture trees can override the universe and scope via
``config={"sharding_axes": [...], "sharding_all_files": True}``.
"""

from __future__ import annotations

import ast
import os
from typing import Iterator, Optional, Set, Tuple

from edl_tpu_torch.analysis.core import Finding, RuleInfo, SourceFile, dotted_name

#: free functions whose positional string arguments are axis names
_AXIS_FUNCS = {
    "ppermute",
    "zero_shard_spec",
    "Shard",
    "shard_batch",
    "global_batch_size",
    "present_axes",
    "axis_size",
    "axis_index",
    "ShardedEmbedding",
}

#: ``Mesh`` lookups by axis name: the first positional argument
_MESH_METHODS = {"group", "axis_size", "axis_index", "slice_ranks",
                 "neighbor", "axis"}

#: mesh constructors that take ``{axis: size}``
_MESH_SPECS = {"MeshSpec", "local_mesh"}

_AXIS_KEYWORDS = {"axis_name", "axis_names"}

_MESH_RELPATH = os.path.join("edl_tpu_torch", "parallel", "mesh.py")


class ShardingConsistencyChecker:
    rule = "EDL003"
    name = "sharding-consistency"
    info = RuleInfo(
        rule="EDL003",
        name="sharding-consistency",
        description=(
            "axis names given to the mesh and collective API in parallel/, "
            "models/, and runtime/ must be declared by AXIS_ORDER in "
            "parallel/mesh.py"
        ),
    )

    def check(self, sf: SourceFile, ctx) -> Iterator[Finding]:
        if not self._applies(sf, ctx):
            return
        declared = self._declared_axes(ctx)
        if declared is None:
            return  # no mesh module (fixture tree without an override)
        for name, node, where in self._candidates(sf.tree):
            if name in declared:
                continue
            yield Finding(
                rule=self.rule,
                path=sf.relpath,
                line=node.lineno,
                col=node.col_offset,
                message=(
                    f"mesh axis '{name}' ({where}) is not declared in "
                    "parallel/mesh.py AXIS_ORDER — a mesh built by this "
                    "codebase never has it"
                ),
            )

    # -- scope / config --------------------------------------------------------

    @staticmethod
    def _applies(sf: SourceFile, ctx) -> bool:
        if ctx.config.get("sharding_all_files"):
            return True
        rel = sf.relpath
        if rel.endswith("parallel/mesh.py"):
            return False  # the declaration site itself
        # runtime/ builds meshes and ZeRO specs (zero_shard_spec) too
        return "parallel/" in rel or "models/" in rel or "runtime/" in rel

    def _declared_axes(self, ctx) -> Optional[Set[str]]:
        override = ctx.config.get("sharding_axes")
        if override is not None:
            return set(override)
        cached = ctx.cache.get("edl003_axes")
        if cached is not None:
            return cached
        mesh_path = os.path.join(ctx.root, _MESH_RELPATH)
        if not os.path.isfile(mesh_path):
            return None
        axes: Set[str] = set()
        try:
            with open(mesh_path, "r", encoding="utf-8") as f:
                tree = ast.parse(f.read(), filename=mesh_path)
        except SyntaxError:
            return None
        for node in ast.walk(tree):
            if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "AXIS_ORDER"
                for t in node.targets
            ):
                if isinstance(node.value, (ast.Tuple, ast.List)):
                    for elt in node.value.elts:
                        if isinstance(elt, ast.Constant) and isinstance(
                            elt.value, str
                        ):
                            axes.add(elt.value)
        axes = axes or None
        ctx.cache["edl003_axes"] = axes
        return axes

    # -- candidate collection --------------------------------------------------

    def _candidates(
        self, tree: ast.AST
    ) -> Iterator[Tuple[str, ast.AST, str]]:
        for node in ast.walk(tree):
            if isinstance(node, ast.Call):
                yield from self._call_candidates(node)
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield from self._default_candidates(node)
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                if isinstance(node.target, ast.Name) and self._axis_named(
                    node.target.id
                ):
                    yield from self._string_values(
                        node.value, f"field '{node.target.id}'"
                    )
            elif isinstance(node, ast.Assign):
                for t in node.targets:
                    if isinstance(t, ast.Name) and self._axis_named(t.id):
                        yield from self._string_values(
                            node.value, f"constant '{t.id}'"
                        )

    @staticmethod
    def _axis_named(name: str) -> bool:
        low = name.lower()
        return low == "axis" or low.endswith(("_axis", "_axes"))

    def _call_candidates(self, node: ast.Call):
        name = dotted_name(node.func)
        base = name.split(".")[-1] if name else ""
        if base in _AXIS_FUNCS and not (
            base in _MESH_METHODS and self._on_mesh(node)
        ):
            for arg in node.args:
                yield from self._string_values(arg, f"{base}(...) axis")
        elif base in _MESH_METHODS and self._on_mesh(node) and node.args:
            yield from self._string_values(node.args[0], f"mesh.{base}(...) axis")
        elif base in _MESH_SPECS:
            for arg in node.args[:1] + [
                kw.value for kw in node.keywords if kw.arg == "axes"
            ]:
                if isinstance(arg, ast.Dict):
                    yield from self._string_values(arg, f"{base}(...) axis")
        for kw in node.keywords:
            if kw.arg in _AXIS_KEYWORDS or (
                kw.arg is not None and self._axis_named(kw.arg)
            ):
                yield from self._string_values(
                    kw.value, f"{kw.arg}= of {base or 'call'}(...)"
                )

    @staticmethod
    def _on_mesh(node: ast.Call) -> bool:
        """``mesh.group(...)`` / ``self._mesh.axis(...)``: a method call on
        a receiver whose last name part says it is a mesh."""
        if not isinstance(node.func, ast.Attribute):
            return False
        owner = dotted_name(node.func.value) or ""
        return "mesh" in owner.rsplit(".", 1)[-1].lower()

    def _default_candidates(self, fn: ast.AST):
        args = fn.args
        pos = args.posonlyargs + args.args
        for arg, default in zip(pos[len(pos) - len(args.defaults):], args.defaults):
            if self._axis_named(arg.arg):
                yield from self._string_values(default, f"default of '{arg.arg}'")
        for arg, default in zip(args.kwonlyargs, args.kw_defaults):
            if default is not None and self._axis_named(arg.arg):
                yield from self._string_values(default, f"default of '{arg.arg}'")

    @staticmethod
    def _string_values(node: ast.AST, where: str):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            yield node.value, node, where
        elif isinstance(node, (ast.Tuple, ast.List, ast.Dict)):
            # a dict ({"pipe": 2} given as mesh_axes=) names its keys
            for elt in node.keys if isinstance(node, ast.Dict) else node.elts:
                if isinstance(elt, ast.Constant) and isinstance(elt.value, str):
                    yield elt.value, elt, where
