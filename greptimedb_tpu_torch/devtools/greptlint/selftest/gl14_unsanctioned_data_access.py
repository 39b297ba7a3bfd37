"""Seeded GL14 violation: a front-end helper reaching into storage
regions directly instead of lowering onto the plan IR (selftest/ is in
the rule's scope so this fixture can live here instead of inside
promql/ or flow/)."""


def series_count(table):
    return sum(r.series_dict.num_series for r in table.regions.values())
