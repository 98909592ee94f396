"""``build_s``: seconds of the index build (``core/build.py``), the
``BuildStats.seconds`` that ``NavixDB.create_index`` returns. Moves
``setup_s``."""


def read(run: dict) -> float:
    return run["build_s"]
