"""intersect.ns_per_member: 1e9 x the ``intersect`` timer over the
``intersect_members`` counter (the sizes of the member lists the loop
reaches), each summed over the window's samples: the loop's cost a member
it intersects. None where a sample lacks either, or the loop reached no
member."""


def read(run):
    t = run.per_sample("intersect_s")
    n = run.per_sample("intersect_members")
    if t is None or not n:
        return None
    return 1e9 * t / n
