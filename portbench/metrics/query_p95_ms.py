"""query_p95_ms: the 95th percentile of the latency of every query in the
window, from the call to synchronized results (host clock), in ms.
Percentiles interpolate linearly between the sorted latencies."""
import statistics


def read(run):
    lat = run.latencies_s
    if len(lat) < 2:
        return lat[0] * 1e3
    return statistics.quantiles(lat, n=20, method="inclusive")[18] * 1e3
