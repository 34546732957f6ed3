"""What the compiler made of a kernel: the opcode mix of its SASS.

``loop_mix`` disassembles a built library with ``cuobjdump -sass`` (from
the toolkit ``nvcc`` belongs to) and counts, for every instance of a
kernel template with one integer parameter, the opcodes of the whole
function and of its largest loop.
"""

from __future__ import annotations

import os
import re
import subprocess
from collections import Counter
from typing import Dict

from flowstate_tpu_torch.kernels import build


def loop_mix(library: str, kernel: str) -> Dict[int, dict]:
    """Per instance ``kernel<k>`` in ``library``, keyed by ``k``: ``"all"``,
    the opcode counts of the function, and ``"loop"``, those of its largest
    loop (the instructions from a backward branch's target to the branch;
    an outer loop holds its inner ones)."""
    tool = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", library], capture_output=True,
                          text=True, check=True).stdout
    listings, code = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            inst = re.search(kernel + r"ILi(\d+)E", m.group(1))
            code = (listings.setdefault(int(inst.group(1)), [])
                    if inst else None)
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
