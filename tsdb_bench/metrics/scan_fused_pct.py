"""scan_fused_pct (%, query/tpu_exec region reduce, program counters):
the share of region scans that the program fused onto an identical scan
in flight (`SCAN_FLIGHTS`: the `scan_fusion_follower` counter) among all
the scans that went through fusion (followers and `scan_fusion_leader`),
counted from the window's start until the clients had drained. Each
statement's window is drawn from the seed, so a share well above 0 says
that statements repeat, and that the traffic no longer is TSBS's."""


def read(w):
    lead = w.counters.get("scan_fusion_leader", 0.0)
    follow = w.counters.get("scan_fusion_follower", 0.0)
    if lead + follow <= 0:
        return None
    return follow / (lead + follow) * 100.0
