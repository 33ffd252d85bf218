"""The Flex collate's 1-edit tier rate: the queries its ``tier`` spans
sent to K4 (their ``tier_queries`` count) over those spans' seconds, in
the traced window's jobs.  ``None`` where the program records no such
span or count."""

from fry_bench.spans import trees


def read(run):
    if run.trace is None:
        return None
    tiers = [sp for t in trees(run) for sp in t.main if sp.name == "tier"]
    seconds = sum(sp.end_ns - sp.start_ns for sp in tiers) / 1e9
    queries = sum(sp.attrs.get("tier_queries", 0) for sp in tiers)
    return queries / seconds if queries and seconds > 0 else None
