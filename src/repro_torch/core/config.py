"""Config system (§3.3): hierarchical YAML -> expanded algorithm instances
(``repro.core.config``).

Schema (exactly the paper's Figure 1):

    <point type>:            # float | bit
      <metric>:              # euclidean | angular | hamming | any
        <algorithm-name>:
          docker-tag: ...    # accepted + ignored (no Docker in this port)
          module: repro_torch.ann  # optional; defaults to the registry
          constructor: BruteForce
          base-args: ["@metric"]
          disabled: false
          run-groups:
            <group-name>:
              args: [[...], ...]        # Cartesian product
              query-args: [[...], ...]  # Cartesian product, re-config only

Expansion semantics (paper §3.3): ``args`` entries are each either a list
(one axis of the Cartesian product) or a scalar (a singleton axis).  Each
expanded argument list yields ONE algorithm instance (one index build);
``query-args`` expands the same way, and each expanded list is applied via
``set_query_arguments`` WITHOUT rebuilding — "this allows built data
structures to be reused, greatly reducing duplicated work".

The special tokens ``@metric``, ``@dimension`` and ``@count`` are substituted
with the experiment's metric, dataset dimensionality and k.

PyYAML is optional: it is imported only for a string or path source, so a
ready dict config needs no YAML at all.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Dict, List, Optional, Sequence

_SUBSTITUTIONS = ("@metric", "@dimension", "@count")


@dataclasses.dataclass(frozen=True)
class Definition:
    """One fully-expanded algorithm instance (= one index build)."""

    algorithm: str                 # config-level algorithm name
    constructor: str
    module: Optional[str]
    arguments: tuple               # positional ctor args after substitution
    query_argument_groups: tuple   # tuple of tuples
    disabled: bool = False
    docker_tag: Optional[str] = None
    run_group: str = "default"

    @property
    def instance_name(self) -> str:
        args = "_".join(str(a) for a in self.arguments)
        return f"{self.algorithm}({args})" if args else self.algorithm


def _axes(entries: Any) -> List[List[Any]]:
    """Turn an args/query-args spec into Cartesian axes.

    Each element of the top-level list is an axis: lists stay lists, scalars
    become singleton axes.  A scalar/empty spec is a single empty product.
    """
    if entries is None:
        return []
    if not isinstance(entries, list):
        entries = [entries]
    return [e if isinstance(e, list) else [e] for e in entries]


def expand_run_group(group: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Expand one run group into (arguments, query_argument_groups) pairs."""
    arg_product = [list(p) for p in itertools.product(*_axes(group.get("args")))]
    if not arg_product:
        arg_product = [[]]
    qaxes = _axes(group.get("query-args", group.get("query_args")))
    query_product = [list(p) for p in itertools.product(*qaxes)] if qaxes else [[]]
    return [
        {"arguments": args, "query_argument_groups": query_product}
        for args in arg_product
    ]


def _substitute(value: Any, metric: str, dimension: int, count: int) -> Any:
    if isinstance(value, str) and value in _SUBSTITUTIONS:
        return {"@metric": metric, "@dimension": dimension, "@count": count}[value]
    if isinstance(value, list):
        return [_substitute(v, metric, dimension, count) for v in value]
    return value


def load_configuration(source: Any) -> Dict[str, Any]:
    """Load a config mapping from a YAML string, path, or ready dict."""
    if isinstance(source, dict):
        return source
    import yaml   # only YAML sources need PyYAML

    if isinstance(source, str):
        if "\n" not in source and source.endswith((".yml", ".yaml")):
            with open(source) as fh:
                return yaml.safe_load(fh)
        return yaml.safe_load(source)
    return yaml.safe_load(source)


def get_definitions(
    source: Any,
    *,
    point_type: str = "float",
    metric: str = "euclidean",
    dimension: int = 0,
    count: int = 10,
    algorithms: Optional[Sequence[str]] = None,
    include_disabled: bool = False,
) -> List[Definition]:
    """Expand a configuration into the full list of algorithm instances."""
    conf = load_configuration(source)
    out: List[Definition] = []
    by_type = conf.get(point_type, {}) or {}
    # "any" metric entries apply to every metric (paper website convention).
    algo_sections: Dict[str, Dict] = {}
    for metric_key in (metric, "any"):
        for name, spec in (by_type.get(metric_key, {}) or {}).items():
            algo_sections.setdefault(name, spec)
    for name, spec in sorted(algo_sections.items()):
        if algorithms is not None and name not in algorithms:
            continue
        disabled = bool(spec.get("disabled", False))
        if disabled and not include_disabled:
            continue
        base_args = _substitute(
            list(spec.get("base-args", spec.get("base_args", [])) or []),
            metric, dimension, count,
        )
        run_groups = spec.get("run-groups", spec.get("run_groups", {})) or {}
        if not run_groups:
            run_groups = {"default": {}}
        for group_name, group in sorted(run_groups.items()):
            for inst in expand_run_group(group or {}):
                args = _substitute(inst["arguments"], metric, dimension, count)
                qgroups = _substitute(
                    inst["query_argument_groups"], metric, dimension, count
                )
                out.append(
                    Definition(
                        algorithm=name,
                        constructor=spec.get("constructor", name),
                        module=spec.get("module"),
                        arguments=tuple(base_args) + tuple(args),
                        query_argument_groups=tuple(tuple(q) for q in qgroups),
                        disabled=disabled,
                        docker_tag=spec.get("docker-tag"),
                        run_group=group_name,
                    )
                )
    return out


def instantiate(definition: Definition):
    """Create the BaseANN instance for a definition."""
    from repro_torch.core import registry

    cls = registry.resolve(definition.constructor, definition.module)
    return cls(*definition.arguments)
