"""Content-keyed, process-safe build of a shared library.

Both native builds of the package (the CUDA kernels, csrc/build.py, and
the libav host runtime, io/build.py) compile at first use into a
gitignored directory inside the package. The output name carries a hash
of the sources and flags, so a stale binary never wins over the sources
on disk. Test runners start several processes at once, so the build
holds an exclusive file lock and publishes the library with an atomic
rename: a process either finds the finished file or waits for the one
building it.
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import pathlib
import subprocess
from typing import Callable, Sequence


def cached_build(
    out_dir: pathlib.Path,
    stem: str,
    sources: Sequence[pathlib.Path],
    compile_to: Callable[[pathlib.Path], Sequence[str]],
    key: str = "",
) -> pathlib.Path:
    """Return ``out_dir/<stem>-<hash>.so``, building it if needed.

    ``compile_to(path)`` gives the compiler command that writes the
    library to ``path``; ``key`` adds flags to the hash. A failed build
    raises RuntimeError with the compiler's output.
    """
    h = hashlib.sha256(key.encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    lib = out_dir / f"{stem}-{h.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / f"{stem}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if lib.exists():  # built by another process while we waited
            return lib
        tmp = out_dir / f".{lib.name}.{os.getpid()}.tmp"
        try:
            cmd = list(compile_to(tmp))
            r = subprocess.run(cmd, capture_output=True, text=True)
            if r.returncode != 0:
                raise RuntimeError(
                    f"building {lib.name} failed ({r.returncode}):\n"
                    f"{' '.join(cmd)}\n{r.stdout}\n{r.stderr}"
                )
            os.replace(tmp, lib)
        finally:
            tmp.unlink(missing_ok=True)
    return lib
