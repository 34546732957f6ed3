"""What the compiler made of a kernel: the opcode mix of its SASS.

``loop_mix`` disassembles a built library with ``cuobjdump -sass`` (from
the toolkit ``nvcc`` belongs to) and counts, for every instance of a
kernel template with integer and bool parameters, the opcodes of the
whole function and of its largest loop.
"""

from __future__ import annotations

import os
import re
import subprocess
from collections import Counter
from typing import Dict, Tuple, Union

from flowstate_tpu_torch.kernels import build


def _template_args(mangled: str, kernel: str
                   ) -> Union[int, Tuple[Union[int, bool], ...], None]:
    """The integer and bool template arguments of ``kernel``'s instance in
    a mangled name: the one integer alone, else a tuple (``kernel<256,
    true>`` is ``(256, True)``); None for another function."""
    m = re.search(kernel + r"I((?:L[ib]\d+E)+)E", mangled)
    if m is None:
        return None
    args = tuple(int(v) if t == "i" else bool(int(v))
                 for t, v in re.findall(r"L([ib])(\d+)E", m.group(1)))
    return args[0] if len(args) == 1 else args


def loop_mix(library: str, kernel: str) -> Dict[object, dict]:
    """Per instance of ``kernel`` in ``library``, keyed by its template
    arguments (``_template_args``): ``"all"``, the opcode counts of the
    function, and ``"loop"``, those of its largest loop (the instructions
    from a backward branch's target to the branch; an outer loop holds its
    inner ones)."""
    tool = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", library], capture_output=True,
                          text=True, check=True).stdout
    listings, code = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            key = _template_args(m.group(1), kernel)
            code = listings.setdefault(key, []) if key is not None else None
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                     r"([A-Z][A-Z0-9_]*)([^;]*)", line)
        if m and code is not None:
            code.append((int(m.group(1), 16), m.group(2), m.group(3)))
    mix = {}
    for key, code in listings.items():
        loop = []
        for addr, op, args in code:
            target = re.search(r"0x([0-9a-f]+)", args) if op == "BRA" else None
            if target and int(target.group(1), 16) < addr:
                body = [o for a, o, _ in code
                        if int(target.group(1), 16) <= a <= addr]
                loop = max(loop, body, key=len)
        mix[key] = {"all": Counter(op for _, op, _ in code),
                    "loop": Counter(loop)}
    return mix
