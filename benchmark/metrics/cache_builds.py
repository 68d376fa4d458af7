"""cache_builds: the fused renderer's cache builds a frame in the window
(count; the port's spans ``tables_build``, a miss of the kernel tables'
cache in ``FusedRenderer.prepare``, and ``shortlists_build``, a miss of the
shortlists' cache in ``FusedRenderer.shortlists``). 0 where none ran;
absent where the program opens no ``frame_setup`` span. Not listed in
``BENCHMARK.json`` yet: in the still cells every build runs in set-up, so
it would read 0 in each run; it comes with a cell that moves the camera or
edits the scene."""

BUILDS = ("tables_build", "shortlists_build")


def read(records: dict):
    spans = records.get("spans", ())
    if not any(name == "frame_setup" for name, _, _ in spans):
        return None
    w = records["window_s"]
    builds = sum(1 for name, s, _ in spans if name in BUILDS and 0.0 <= s <= w)
    return builds / records["frames"]
