"""Model-URI resolution for the filter's ``model=`` property.

A copy of ``nnstreamer_tpu/core/model_uri.py`` (the reference's
``mlagent://model/<name>/<version>``, ``ml_agent.c:106``):

* a plain path or name is returned as it is;
* ``file://<path>`` is stripped;
* ``model://<name>[/<version>]`` is looked up in the local model
  repository (``$NNS_TPU_MODEL_REPO``, else config ``[model-repo] path``,
  else ``~/.nnstreamer_tpu/models``): ``<repo>/<name>/<version>/``, with
  ``latest`` (the default) the highest numeric version.  A version holding
  one file resolves to that file, otherwise to the directory.
"""

from __future__ import annotations

import os
from typing import Optional

from . import config


def repo_dir() -> str:
    env = os.environ.get("NNS_TPU_MODEL_REPO")
    if env:
        return env
    return config.get_value("model-repo", "path", os.path.expanduser("~/.nnstreamer_tpu/models"))


def _resolve_version(name_dir: str, version: str) -> Optional[str]:
    if version != "latest":
        d = os.path.join(name_dir, version)
        return d if os.path.exists(d) else None
    try:
        entries = os.listdir(name_dir)
    except OSError:
        return None
    versions = []
    for entry in entries:
        try:
            versions.append(([int(p) for p in entry.split(".")], entry))
        except ValueError:  # non-numeric or malformed ('1.', 'v2', ...)
            continue
    return os.path.join(name_dir, max(versions)[1]) if versions else None


def resolve_model_uri(uri: str) -> str:
    """A model= value as a concrete path, or unchanged when it is not a
    URI.  Raises FileNotFoundError for a model:// URI that does not
    resolve."""
    if uri.startswith("file://"):
        return uri[len("file://"):]
    if not uri.startswith("model://"):
        return uri
    rest = uri[len("model://"):].strip("/")
    if not rest:
        raise FileNotFoundError("model:// URI needs a model name")
    name, _, version = rest.partition("/")
    vdir = _resolve_version(os.path.join(repo_dir(), name), version or "latest")
    if vdir is None:
        raise FileNotFoundError(f"{uri}: not found under model repo {repo_dir()!r}")
    if os.path.isdir(vdir):
        files = [e for e in sorted(os.listdir(vdir)) if not e.startswith(".")]
        if len(files) == 1:
            return os.path.join(vdir, files[0])
    return vdir
