"""Host time of relocalization per LOST frame: the program's
`kfdb_detect_reloc`, `reloc_candidate` and `reloc_refine` spans over the
window, divided by the frames that completed LOST there (the profiled
stretch left out of both)."""
NAME = "reloc_ms_per_lost_frame"
UNIT = "ms"
LAYER = "relocalization (Tracker._relocalize, map/keyframe_db.py, solvers/pnp.py, solvers/epnp.py)"
SOURCE = "program_span"
MOVES = "call_ms_p95"


def read(run):
    lost = run.counts.get("lost", 0)
    total = sum(run.spans.get(n, (0.0, 0))[0]
                for n in ("kfdb_detect_reloc", "reloc_candidate", "reloc_refine"))
    return total / lost * 1e3 if lost and total else None
