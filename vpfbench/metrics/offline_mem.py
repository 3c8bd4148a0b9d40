"""The ``.offline_mem`` readers: the same readings as the ``.offline``
ones, named apart because in their cells they move ``peak_mem_gib``, the
end-to-end metric those cells report in place of ``frames_per_s``."""

from pathlib import Path


def reader(name: str):
    """The ``read`` of ``metrics/<name>.py``."""
    from ..harness import load_module

    return load_module(Path(__file__).with_name(f"{name}.py"),
                       "metrics").read
