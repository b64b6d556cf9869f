"""AST-based parameter registry: build CLI options from dataclass source
without importing it.

Re-implements the reference's config system
(reference: src/segger/cli/registry.py:33-563): the source of truth for
defaults and help text is the class definition itself (``PipelineConfig``,
``TrainConfig``, ...), scraped with ``ast`` so ``segger-tpu-torch
--help`` never pays the torch import cost.  Numpydoc-style ``Parameters`` sections
feed the per-option help strings; cross-class name conflicts are
detected at merge time.
"""
from __future__ import annotations

import ast
import re
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, List, Optional


@dataclass
class ParameterInfo:
    name: str
    default: Any
    annotation: str
    help: str = ""
    source: str = ""

    @property
    def type(self):
        """Best-effort Python type for argparse conversion."""
        a = self.annotation
        if "bool" in a:
            return bool
        if "int" in a:
            return int
        if "float" in a:
            return float
        return str

    @property
    def choices(self) -> Optional[List[str]]:
        m = re.search(r"Literal\[([^\]]+)\]", self.annotation)
        if not m:
            return None
        return [
            s.strip().strip("'\"") for s in m.group(1).split(",")
        ]


def _literal(node: ast.AST) -> Any:
    try:
        return ast.literal_eval(node)
    except Exception:
        return None


def _parse_numpydoc_params(docstring: str) -> Dict[str, str]:
    """Extract {param: description} from a numpydoc Parameters section
    (reference: registry.py:189-252)."""
    if not docstring:
        return {}
    out: Dict[str, str] = {}
    lines = docstring.splitlines()
    in_params = False
    current = None
    buf: List[str] = []
    for i, line in enumerate(lines):
        stripped = line.strip()
        if stripped == "Parameters":
            in_params = True
            continue
        if in_params and set(stripped) == {"-"} and stripped:
            continue
        if in_params:
            # a header is "name : type" (numpydoc's space-colon) or a
            # bare identifier — a description line that merely contains
            # a colon ("adaptive: split by count") must not start a
            # bogus parameter and truncate the real help text
            if stripped and not line.startswith((" " * 8, "\t\t")) and (
                (" : " in stripped
                 and stripped.split(" : ")[0].strip().isidentifier())
                or stripped.isidentifier()
            ):
                # new parameter header like "name : type"
                if current:
                    out[current] = " ".join(buf).strip()
                current = stripped.split(":")[0].strip()
                buf = []
            elif stripped == "" and current and buf:
                out[current] = " ".join(buf).strip()
                current = None
                buf = []
            elif current is not None:
                buf.append(stripped)
    if current and buf:
        out[current] = " ".join(buf).strip()
    return out


class ParameterRegistry:
    """Scrapes dataclass fields + ``__init__`` keyword defaults from
    source files; merges with conflict detection
    (reference: registry.py:57-117, 320-361)."""

    def __init__(self):
        self.parameters: Dict[str, ParameterInfo] = {}

    def register_from_file(
        self,
        path,
        class_name: str,
        exclude: Optional[List[str]] = None,
    ) -> "ParameterRegistry":
        source = Path(path).read_text()
        tree = ast.parse(source)
        exclude = set(exclude or [])
        for node in ast.walk(tree):
            if not (
                isinstance(node, ast.ClassDef) and node.name == class_name
            ):
                continue
            doc_params = _parse_numpydoc_params(
                ast.get_docstring(node) or ""
            )
            # dataclass-style annotated assignments
            for stmt in node.body:
                if isinstance(stmt, ast.AnnAssign) and isinstance(
                    stmt.target, ast.Name
                ):
                    name = stmt.target.id
                    if name.startswith("_") or name in exclude:
                        continue
                    default = (
                        _literal(stmt.value)
                        if stmt.value is not None
                        else None
                    )
                    self._add(
                        ParameterInfo(
                            name=name,
                            default=default,
                            annotation=ast.unparse(stmt.annotation),
                            help=doc_params.get(name, ""),
                            source=f"{class_name}",
                        )
                    )
                # __init__ keyword defaults
                if (
                    isinstance(stmt, ast.FunctionDef)
                    and stmt.name == "__init__"
                ):
                    args = stmt.args
                    n_def = len(args.defaults)
                    for arg, d in zip(
                        args.args[-n_def:] if n_def else [],
                        args.defaults,
                    ):
                        if arg.arg in ("self",) or arg.arg in exclude:
                            continue
                        self._add(
                            ParameterInfo(
                                name=arg.arg,
                                default=_literal(d),
                                annotation=(
                                    ast.unparse(arg.annotation)
                                    if arg.annotation
                                    else ""
                                ),
                                help=doc_params.get(arg.arg, ""),
                                source=f"{class_name}",
                            )
                        )
        return self

    def _add(self, info: ParameterInfo):
        prev = self.parameters.get(info.name)
        if prev is not None and prev.default != info.default:
            raise ValueError(
                f"Conflicting defaults for parameter '{info.name}': "
                f"{prev.source}={prev.default!r} vs "
                f"{info.source}={info.default!r}"
            )
        if prev is None:
            self.parameters[info.name] = info

    def get_default(self, name: str):
        return self.parameters[name].default

    def add_arguments(self, parser, names: Optional[List[str]] = None):
        """Emit argparse options (the cyclopts-Parameter analogue,
        reference: registry.py:363-457)."""
        for name, info in self.parameters.items():
            if names is not None and name not in names:
                continue
            flag = "--" + name.replace("_", "-")
            kwargs: Dict[str, Any] = {
                "default": info.default,
                "help": (info.help or "") + f" (default: {info.default})",
            }
            if info.type is bool:
                kwargs["type"] = _str2bool
                kwargs["metavar"] = "BOOL"
            else:
                kwargs["type"] = info.type
                choices = info.choices
                if choices:
                    kwargs["choices"] = choices
            parser.add_argument(flag, **kwargs)
        return parser

    def collect(self, namespace, names: List[str]) -> Dict[str, Any]:
        """Pick parsed values back out of an argparse namespace."""
        return {
            n: getattr(namespace, n)
            for n in names
            if hasattr(namespace, n)
        }


def _str2bool(v: str) -> bool:
    if isinstance(v, bool):
        return v
    if v.lower() in ("true", "1", "yes", "y"):
        return True
    if v.lower() in ("false", "0", "no", "n"):
        return False
    raise ValueError(f"Not a boolean: {v!r}")
