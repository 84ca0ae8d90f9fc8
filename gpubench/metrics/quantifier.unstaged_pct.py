"""quantifier.unstaged_pct: 100 x the share of ``quantify_files``' wall
time (``wall_s``) that no top-level span covers, summed over the window's
samples. The top-level spans are ``mapper``, ``map``, ``resolve``,
``ec_table``, ``em``, ``bootstrap`` (absent without replicates) and
``collect``."""

SPANS = ("mapper_s", "map_s", "resolve_s", "ec_table_s", "em_s",
         "collect_s")


def read(run):
    if not run.samples or any(k not in s for s in run.samples
                              for k in SPANS + ("wall_s",)):
        return None
    wall = sum(s["wall_s"] for s in run.samples)
    staged = sum(s[k] for s in run.samples for k in SPANS) + sum(
        s.get("bootstrap_s", 0.0) for s in run.samples)
    return 100.0 * (wall - staged) / wall if wall > 0 else None
