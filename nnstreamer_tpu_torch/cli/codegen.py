"""Custom-filter scaffolding generator.

Port of ``nnstreamer_tpu/cli/codegen.py`` (≙ the reference's
``tools/development/nnstreamerCodeGenCustomFilter.py``): emits a
ready-to-build skeleton for a user filter, in either dialect:

* ``--lang python`` — a ``CustomFilter`` class of the port's ``python3``
  backend (run with ``tensor_filter framework=python3 model=<file.py>``).
* ``--lang c`` — a source implementing the port's copy of the
  ``nns_tpu_custom_filter.h`` C ABI (``native/include``) plus a Makefile
  (run with ``tensor_filter framework=custom model=<path.so>``).

CLI: ``python -m nnstreamer_tpu_torch.cli.codegen <name> [--lang python|c] [-o DIR]``
(``nns-tpu-torch-codegen``).
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

_PY_TEMPLATE = '''"""Custom filter `{name}` — generated scaffold.

Run in a pipeline:  tensor_filter framework=python3 model={name}.py
"""

import numpy as np


class CustomFilter:
    """User filter of the python3 backend: get_model_info (a static
    schema) or set_input_info (shape-polymorphic), plus invoke."""

    def set_options(self, custom):
        # the filter's custom= properties as a dict
        self.custom = custom

    def get_model_info(self):
        # "type:dims" per tensor, dims innermost first: (3, 224, 224) uint8
        return ["uint8:224:224:3"], ["uint8:224:224:3"]

    def invoke(self, inputs):
        # inputs: list of np.ndarray; return list of np.ndarray
        return [np.asarray(inputs[0])]


filter = CustomFilter
'''

_C_TEMPLATE = """/* Custom filter `{name}` — generated scaffold.
 * Build: make (C, or C++: make CC=g++)
 * Run: tensor_filter framework=custom model=./{name}.so
 */

#include <stdlib.h>
#include <string.h>
#include "nns_tpu_custom_filter.h"

typedef struct {{
  int dummy;
}} {name}_ctx;

void *
nns_custom_open (const char *custom_props)
{{
  {name}_ctx *ctx = ({name}_ctx *) calloc (1, sizeof ({name}_ctx));
  (void) custom_props;
  return ctx;
}}

int
nns_custom_get_model_info (void *handle,
    nns_tensor_spec *in_specs, uint32_t *num_in,
    nns_tensor_spec *out_specs, uint32_t *num_out)
{{
  (void) handle;
  /* one uint8 tensor (3,224,224) in and out — edit to taste, or return
   * nonzero and implement nns_custom_set_input_info instead. */
  in_specs[0].dtype = NNS_UINT8;
  in_specs[0].rank = 3;
  in_specs[0].dims[0] = 3;
  in_specs[0].dims[1] = 224;
  in_specs[0].dims[2] = 224;
  *num_in = 1;
  out_specs[0] = in_specs[0];
  *num_out = 1;
  return 0;
}}

int
nns_custom_invoke (void *handle,
    const nns_tensor_mem *inputs, uint32_t num_in,
    nns_tensor_mem *outputs, uint32_t num_out)
{{
  (void) handle;
  (void) num_in;
  (void) num_out;
  /* passthrough — replace with real work */
  memcpy (outputs[0].data, inputs[0].data, inputs[0].nbytes);
  return 0;
}}

void
nns_custom_close (void *handle)
{{
  free (handle);
}}
"""

_MAKEFILE_TEMPLATE = """CXXFLAGS ?= -O2 -fPIC -Wall
INCLUDE := {include_dir}

{name}.so: {name}.c
\t$(CC) $(CXXFLAGS) -I$(INCLUDE) -shared -o $@ $<

clean:
\trm -f {name}.so
"""


def generate(name: str, lang: str, outdir: str) -> List[str]:
    os.makedirs(outdir, exist_ok=True)
    written: List[str] = []
    cls = "".join(w.capitalize() for w in name.replace("-", "_").split("_"))
    if lang == "python":
        path = os.path.join(outdir, f"{name}.py")
        with open(path, "w") as f:
            f.write(_PY_TEMPLATE.format(name=name, cls=cls))
        written.append(path)
    elif lang == "c":
        include_dir = os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            "native",
            "include",
        )
        cpath = os.path.join(outdir, f"{name}.c")
        with open(cpath, "w") as f:
            f.write(_C_TEMPLATE.format(name=name))
        mpath = os.path.join(outdir, "Makefile")
        with open(mpath, "w") as f:
            f.write(_MAKEFILE_TEMPLATE.format(name=name, include_dir=include_dir))
        written.extend([cpath, mpath])
    else:
        raise ValueError(f"unknown lang {lang!r}")
    return written


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="nns-tpu-torch-codegen", description="generate custom-filter scaffolding"
    )
    ap.add_argument("name", help="filter name (file/symbol prefix)")
    ap.add_argument("--lang", choices=("python", "c"), default="python")
    ap.add_argument("-o", "--outdir", default=".")
    args = ap.parse_args(argv)
    for path in generate(args.name, args.lang, args.outdir):
        print(f"wrote {path}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
