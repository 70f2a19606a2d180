"""Lazy package namespaces (PEP 562).

A package of the port names what it exports in a table, {submodule:
names}, and hands the table to :func:`install`.  Its names then resolve on
first access, each by importing only its own submodule, so importing the
package, or one submodule of it, imports nothing else.
"""

from __future__ import annotations

import importlib
from typing import Dict, Iterable

__all__ = ["install"]


def install(namespace: dict, exports: Dict[str, Iterable[str]]) -> None:
    """Give the package whose globals are ``namespace`` the names of
    ``exports`` (``{"ops.fft": ("fft", ...), ...}``, submodules under
    ``simpledsp_tpu_torch``): sets its ``__all__``, and a ``__getattr__``
    that imports a name's submodule on first access and keeps the name, and
    a ``__dir__`` that lists the names."""
    module_of = {name: f"simpledsp_tpu_torch.{mod}"
                 for mod, names in exports.items() for name in names}
    package = namespace["__name__"]

    def __getattr__(name: str):
        try:
            module = module_of[name]
        except KeyError:
            raise AttributeError(f"module {package!r} has no attribute "
                                 f"{name!r}") from None
        value = getattr(importlib.import_module(module), name)
        namespace[name] = value
        return value

    def __dir__():
        return sorted(set(namespace) | set(module_of))

    namespace.update(__all__=list(module_of), __getattr__=__getattr__,
                     __dir__=__dir__)
