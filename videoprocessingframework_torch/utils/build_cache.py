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
import tempfile
from typing import Callable, Sequence

#: one compiler command; a build is a list of steps, each a list of
#: commands started together
Command = Sequence[str]


def run_together(cmds: Sequence[Command]) -> None:
    """Start every command at once and wait for all; raise RuntimeError
    with the output of each that failed."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True))
             for cmd in cmds]
    failed = []
    for cmd, proc in procs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"({proc.returncode}) {' '.join(cmd)}\n{out}\n{err}")
    if failed:
        raise RuntimeError("build failed:\n" + "\n".join(failed))


def cached_build(
    out_dir: pathlib.Path,
    stem: str,
    sources: Sequence[pathlib.Path],
    compile_to: Callable[[pathlib.Path], Sequence[Sequence[Command]]],
    key: str = "",
) -> pathlib.Path:
    """Return ``out_dir/<stem>-<hash>.so``, building it if needed.

    ``compile_to(path)`` gives the build that writes the library to
    ``path``: steps run in order, the commands of a step started together
    (:func:`run_together`). Intermediate files belong in ``path.parent``,
    a scratch directory removed after the build. ``key`` adds flags to
    the hash. A failed build raises RuntimeError with the compiler's
    output.
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
        with tempfile.TemporaryDirectory(dir=out_dir,
                                         prefix=f".{stem}-") as work:
            tmp = pathlib.Path(work) / lib.name
            for step in compile_to(tmp):
                run_together(step)
            os.replace(tmp, lib)
    return lib
