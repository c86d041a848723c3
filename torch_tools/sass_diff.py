"""Compare the SASS of the port's kernels between two checkouts.

Builds every ``csrc/*.cu`` library of both checkouts (each into its own
``build/kernels``), disassembles them with ``cuobjdump -sass`` and checks,
function by function, that every kernel of the first checkout is in the
second with the same instructions (the anonymous namespace's name, which
holds a hash of the source's path, and the instruction addresses are
normalised).  Functions only the second holds are counted as new.  Run on
a machine with nvcc and cuobjdump:

    python torch_tools/sass_diff.py OLD_CHECKOUT NEW_CHECKOUT

Prints one line a library and ``SASS_IDENTICAL`` or ``SASS_DIFFERS n``
last; exits 1 when a function differs or is missing.
"""

import json
import os
import re
import subprocess
import sys

NAMES = ["mcd_lstm_seq", "mcd_gru_seq", "mcd_lstm_step", "mcd_gru_step",
         "masked_activation", "mcd_matmul", "decode_attn", "ssd_chunk"]


def build(tree) -> dict:
    """Build the checkout's libraries; name -> library path."""
    code = ("import json, sys; sys.path.insert(0, 'src'); "
            "from repro_torch.kernels import build; "
            f"build.build_all({NAMES!r}); "
            f"print(json.dumps({{n: str(build.library_path(n)) "
            f"for n in {NAMES!r}}}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=tree, check=True,
                         capture_output=True, text=True).stdout
    return json.loads(out.splitlines()[-1])


def cuobjdump():
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    return os.path.join(home, "bin", "cuobjdump")


def sass(lib):
    out = subprocess.run([cuobjdump(), "-sass", lib], capture_output=True,
                         text=True, check=True).stdout
    funcs, cur = {}, None
    for line in out.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = re.sub(r"_GLOBAL__N__[0-9a-f]{8}_\d+_\w+?_cu_[0-9a-f]{8}",
                         "ANON", m.group(1))
            funcs[cur] = []
            continue
        if cur is not None:
            funcs[cur].append(re.sub(r"/\*[0-9a-f]{4,}\*/", "", line).strip())
    return funcs


def main(old, new):
    old_libs, new_libs = build(old), build(new)
    bad = 0
    for n in NAMES:
        os_, ns = sass(old_libs[n]), sass(new_libs[n])
        diff = [f for f in os_ if ns.get(f) != os_[f]]
        print(f"{n}: old functions {len(os_)}, identical "
              f"{len(os_) - len(diff)}, differing {len(diff)}, new "
              f"functions {len(set(ns) - set(os_))}")
        for f in diff:
            print("   DIFF", f, "missing" if f not in ns else "")
        bad += len(diff)
    print("SASS_IDENTICAL" if bad == 0 else f"SASS_DIFFERS {bad}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main(os.path.abspath(sys.argv[1]), os.path.abspath(sys.argv[2])))
