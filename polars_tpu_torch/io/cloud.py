"""Paths and the cloud API surface (the port of ``polars_tpu/io/cloud.py``,
over local paths only).

A scan or a writer takes local paths, directories and globs
(``io/parquet._expand_paths``). A URL with a scheme other than ``file://``
raises: the port has no object-store client (the JAX package reaches one
through ``fsspec``). The credential providers and ``Catalog`` are accepted
where the reference accepts them and are never invoked for a local path;
calling a provider, or any method of a catalog, raises.
"""

from __future__ import annotations

from typing import Any

from polars_tpu_torch.errors import ComputeError


class CredentialProvider:
    """Base class for credential providers."""

    def __call__(self) -> Any:
        raise NotImplementedError("cloud object stores are unavailable in this build (local IO only)")


class CredentialProviderFunction(CredentialProvider):
    def __init__(self, function: Any = None) -> None:
        self.function = function


CredentialProviderFunctionReturn = tuple


class CredentialProviderAWS(CredentialProvider):
    def __init__(self, *, profile_name: str | None = None, region_name: str | None = None, **kw: Any) -> None:
        self.profile_name = profile_name
        self.region_name = region_name


class CredentialProviderGCP(CredentialProvider):
    def __init__(self, *, scopes: Any = None, **kw: Any) -> None:
        self.scopes = scopes


class CredentialProviderAzure(CredentialProvider):
    def __init__(self, *, scopes: Any = None, tenant_id: str | None = None, **kw: Any) -> None:
        self.scopes = scopes
        self.tenant_id = tenant_id


def is_remote_path(path: Any) -> bool:
    s = str(path)
    return "://" in s and not s.startswith("file://")


def _refuse_remote(path: Any) -> None:
    raise ComputeError(f"{str(path)!r}: the port reads and writes local paths only (no object-store client)")


def expand_remote_paths(source: Any, suffix: str = "", storage_options: Any = None) -> tuple[str, ...]:
    """A remote glob or directory: refused (local paths only)."""
    _refuse_remote(source)


def open_remote(path: Any, mode: str = "rb", storage_options: Any = None):
    """A remote file to write: refused (local paths only)."""
    _refuse_remote(path)


class Catalog:
    """Unity Catalog client (reference: py-polars catalog/unity/client.py:47).

    Its REST API needs the network, which the port does not use:
    construction is allowed so that the name round-trips, and every call
    raises."""

    def __init__(self, workspace_url: str, *, bearer_token: str | None = "auto", require_https: bool = True) -> None:
        if require_https and not str(workspace_url).startswith("https://"):
            raise ValueError(f"a non-HTTPS workspace_url requires require_https=False: {workspace_url!r}")
        self.workspace_url = workspace_url

    def __getattr__(self, name: str):
        def _unavailable(*a, **k):
            raise OSError(f"Catalog.{name}: the Unity Catalog REST API is unreachable (the port uses no network)")

        return _unavailable
