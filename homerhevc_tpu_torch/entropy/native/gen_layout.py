"""Generate layout.h for the native CABAC backend from the Python
single-source-of-truth tables (entropy/cabac.py). Called by the build in
entropy/native_backend.py, which writes the text into its build directory
and passes that directory to g++ with -I."""

from __future__ import annotations

import numpy as np


def render() -> str:
    """The text of layout.h."""
    from .. import cabac

    lines = ["// Auto-generated by gen_layout.py — do not edit.",
             "#pragma once", "#include <cstdint>", ""]
    for name, _n in cabac._LAYOUT:
        lines.append(f"#define OFF_{name} {cabac.OFF[name]}")
    lines.append(f"#define NUM_CTX {cabac.NUM_CTX}")
    lines.append("")

    def dump(name, arr, ctype="uint8_t"):
        a = np.asarray(arr)
        flat = ", ".join(str(int(v)) for v in a.reshape(-1))
        dims = "".join(f"[{d}]" for d in a.shape)
        lines.append(f"static const {ctype} {name}{dims} = {{{flat}}};")

    dump("RANGE_TAB_LPS", cabac.RANGE_TAB_LPS)
    dump("TRANS_IDX_LPS", cabac.TRANS_IDX_LPS)
    dump("TRANS_IDX_MPS", cabac.TRANS_IDX_MPS)
    lines.append("")
    return "\n".join(lines) + "\n"
