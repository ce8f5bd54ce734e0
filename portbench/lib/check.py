"""The decision of ``correct``: the sampled answers of the window against
the plain reference that the cell's configuration names
(``reference/<name>.py``, ``cell.reference``) run on the same frames.

Numbers compared, each against its limit in ``limits/<cell>.json``:

* ``xy_gap_px``: the largest gap between the program's and the
  reference's vector coordinates (exact: limit 0);
* ``skip_mismatch``: sampled pairs that one side skips (more than half
  the field invalid) and the other does not (exact: limit 0);
* ``uv_gap_p99_px``: the 99th percentile, over every vector of the sampled
  pairs, of the larger of the ``u`` and ``v`` gaps, in pixels.

Read and printed, compared only where the limits file gives a limit:
``uv_gap_p999_px`` and ``uv_gap_max_px`` (the same gaps' 99.9th percentile
and largest), ``uv_over_1e-4px_pct`` and ``uv_over_1e-3px_pct`` (the share
of vectors whose gap is above 1e-4 or 1e-3 px: a wrong row or block of
vectors shows there, where a percentile may pass it), and
``mask_mismatch_pct``, the share of vectors whose invalid flag differs,
where the window's answers carry the flags (the staged mixes).
"""
from __future__ import annotations

import sys
from typing import Dict, List, Optional, Tuple

import numpy as np

# the shares of vectors read above these gaps
OVER_PX = {"uv_over_1e-4px_pct": 1e-4, "uv_over_1e-3px_pct": 1e-3}


def reference_answers(ref, frames, pairs, engine_cfg: dict, precision: str = "float64"):
    """``pair -> ((x, y, u, v) or None, invalid)`` of the reference module
    ``ref``."""
    fa, fb = frames
    out = {}
    for k in sorted(set(pairs)):
        out[k] = ref.run(fa[k], fb[k], engine_cfg, precision)
    return out


def numbers(ref, samples: List[dict], answers: Dict, engine_cfg: dict) -> Dict[str, float]:
    """The compared numbers of ``samples`` (``pair``, ``field``,
    ``invalid``) against ``answers``; ``ref``'s settings give the units."""
    c = ref.settings(engine_cfg)
    unit = c["scale"] / c["dt"] * 1000
    xy, skips, gaps, flags, masks = 0.0, 0, [], 0, 0
    for s in samples:
        want, want_inval = answers[s["pair"]]
        got = s["field"]
        if (got is None) != (want is None):
            skips += 1
            continue
        if s.get("invalid") is not None:
            flags += int(np.count_nonzero(np.asarray(s["invalid"]) != want_inval))
            masks += want_inval.size
        if got is None:
            continue
        xy = max(xy, float(np.abs(got[0] - want[0]).max()),
                 float(np.abs(got[1] - want[1]).max()))
        gap = np.maximum(np.abs(got[2] - want[2]), np.abs(got[3] - want[3])) / unit
        gaps.append(np.nan_to_num(gap, nan=np.inf).ravel())
    allgaps = np.concatenate(gaps) if gaps else np.zeros(1)
    out = {"xy_gap_px": xy, "skip_mismatch": float(skips),
           "uv_gap_p99_px": float(np.percentile(allgaps, 99)),
           "uv_gap_p999_px": float(np.percentile(allgaps, 99.9)),
           "uv_gap_max_px": float(allgaps.max())}
    for name, over in OVER_PX.items():
        out[name] = 100.0 * float(np.count_nonzero(allgaps > over)) / allgaps.size
    if masks:
        out["mask_mismatch_pct"] = 100.0 * flags / masks
    return out


def judge(nums: Dict[str, float], limits: Dict[str, float], checked: int,
          least: int) -> Tuple[bool, Dict[str, dict]]:
    """Each number that has a limit beside it; ``correct`` where every one
    is within its limit and at least ``least`` answers were checked."""
    table = {"checked_pairs": {"value": checked, "limit": least}}
    ok = checked >= least
    for name, lim in limits.items():
        value = nums[name]
        table[name] = {"value": value, "limit": lim}
        ok = ok and value <= lim
    return ok, table


def report(table: Dict[str, dict], readings: Dict[str, float]) -> None:
    """The numbers that are not compared (for the record), then the
    compared ones as the last lines of standard error."""
    for name, value in readings.items():
        if name not in table:
            print(f"reading {name} {value!r} (not compared)", file=sys.stderr)
    for name, row in table.items():
        rel = ">=" if name == "checked_pairs" else "<="
        print(f"check {name} {row['value']!r} {rel} {row['limit']!r}",
              file=sys.stderr, flush=True)


def decide(cell, samples: List[dict], precision: str = "float64"):
    """``(correct, table, numbers)`` of a window's sampled answers."""
    answers = reference_answers(cell.reference, cell.frames, [s["pair"] for s in samples],
                                cell.reference_config, precision)
    nums = numbers(cell.reference, samples, answers, cell.reference_config)
    ok, table = judge(nums, cell.limits["limits"], len(samples),
                      int(cell.limits.get("least_checked", 1)))
    return ok, table, nums
