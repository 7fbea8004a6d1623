"""Shuffle-quality analysis: correlation of shuffled vs ordered id streams.

Parity: reference ``petastorm/test_util/shuffling_analysis.py:52-85``
(``compute_correlation_distribution``).
"""

import numpy as np


def compute_correlation_distribution(ordered_ids, shuffled_id_streams):
    """|corrcoef| of each shuffled stream against the ordered stream.

    Low values mean good decorrelation. Returns (mean, per-stream list).
    """
    ordered = np.asarray(ordered_ids, dtype=np.float64)
    correlations = []
    for stream in shuffled_id_streams:
        stream = np.asarray(stream, dtype=np.float64)
        n = min(len(ordered), len(stream))
        if n < 2:
            continue
        corr = abs(float(np.corrcoef(ordered[:n], stream[:n])[0, 1]))
        correlations.append(corr)
    return (float(np.mean(correlations)) if correlations else 0.0), correlations
