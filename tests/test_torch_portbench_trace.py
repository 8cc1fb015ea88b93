"""The benchmark's trace reader, its program spans and its per-layer
arithmetic (portbench/tests/test_portbench_trace.py and
test_portbench_spans.py, on synthetic traces and a host profile),
collected with the repository's tests."""

from portbench.tests.test_portbench_spans import (  # noqa: F401
    test_idle_shares_by_span,
    test_launches_and_tie,
    test_new_metrics_arithmetic,
    test_new_metrics_find_nothing_they_cannot_tie,
    test_old_metrics_read_the_same_beside_the_new_spans,
    test_open_spans_and_overlap,
    test_program_regions_in_a_real_profile_on_the_host,
    test_tie_says_why_it_refuses_once_a_trace,
)
from portbench.tests.test_portbench_trace import (  # noqa: F401
    test_end_to_end_arithmetic,
    test_layer_metrics_arithmetic,
    test_parse_busy_idle_and_gaps,
    test_readers_find_nothing_without_a_trace,
    test_records_of_a_real_profile_on_the_host,
    test_short_kernel_names,
)
