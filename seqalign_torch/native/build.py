"""Build shared libraries on first use.

``build_shared`` compiles one source into ``seqalign_torch/_build/``
under a name that carries a digest of the source, its headers and the
command, so an edited source builds anew and a built one is reused.  A
file lock keeps two processes from building the same library at once,
and the library is linked to a temporary path and renamed into place, so
no process ever maps a half-written file.  ``ensure_built`` builds the native oracle
(``oracle.cpp``) with ``g++``.
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import subprocess
from typing import Callable, Sequence

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
SOURCE = os.path.join(_DIR, "oracle.cpp")


def build_shared(name: str, source: str,
                 command: Callable[[str], Sequence[str]],
                 headers: Sequence[str] = ()) -> str:
    """Return the path of ``lib<name>.<digest>.so`` built from ``source``.

    ``command(out_path)`` gives the compiler's argv writing to
    ``out_path``; ``headers`` are files the source includes, digested
    with it.  The compiler's messages go to ``<library>.log``.  Raises
    RuntimeError with the compiler's output when the build fails.
    """
    digest = hashlib.sha256()
    for path in (source, *headers):
        with open(path, "rb") as f:
            digest.update(f.read())
    digest.update(" ".join(command("OUT")).encode())
    library = os.path.join(
        BUILD_DIR, f"lib{name}.{digest.hexdigest()[:12]}.so"
    )
    if os.path.exists(library):
        return library
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(library + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(library):
            return library
        tmp = f"{library}.tmp.{os.getpid()}"
        try:
            proc = subprocess.run(
                list(command(tmp)), capture_output=True, text=True
            )
            with open(library + ".log", "w") as log:
                log.write(proc.stdout + proc.stderr)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"building {name} from {source} failed:\n"
                    f"{proc.stdout}{proc.stderr}"
                )
            os.replace(tmp, library)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return library


def ensure_built() -> str:
    """Return the path of the native oracle library, compiling if needed."""
    return build_shared(
        "seqalign_oracle", SOURCE,
        lambda out: ["g++", "-O3", "-std=c++17", "-shared", "-fPIC",
                     "-o", out, SOURCE],
    )


if __name__ == "__main__":
    print(ensure_built())
