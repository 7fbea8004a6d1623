"""``WeightedSamplingReader``: each ``next`` draws one of N readers at random
by weight (counterpart of ``petastorm_tpu/weighted_sampling_reader.py:22-
183``), the data-mixture reader of LM pre-training.

The draw is the JAX package's: ``np.random.default_rng(seed)``'s next
``random()`` against the cumulative normalised weights
(``np.searchsorted(cum, draw, side='right')``), one draw a row (per-row
readers) or a row-group chunk (batched readers), so one seed gives both
packages the same source sequence. Provenance passes each source's segment
through, tagged with its ``source`` index, under a ``mode='mixture'``
context; ``state_dict()`` carries the draw generator's state and each
source's own state, in the JAX package's layout, so a state of either
package resumes the other. Each draw bumps the per-source counter
``pst_weighted_reader_draws_total{source}`` (``:66-71``).
"""

import numpy as np

from petastorm_tpu_torch import metrics

STATE_VERSION = 1


class WeightedSamplingReader(object):
    """Mixes ``readers`` with ``probabilities`` (any positive weights,
    normalised). All must yield the same fields, all batched or all per
    row, none or all NGram. ``resume_state``: a :meth:`state_dict` of a
    mixture of as many sources; build each source with its entry of
    ``state['sources']`` first."""

    def __init__(self, readers, probabilities, seed=None, resume_state=None):
        if len(readers) != len(probabilities):
            raise ValueError('readers and probabilities must have equal length')
        if len(readers) < 1:
            raise ValueError('Need at least one reader')
        total = float(sum(probabilities))
        if total <= 0:
            raise ValueError('probabilities must sum to a positive value')
        self._readers = list(readers)
        self._cum = np.cumsum([p / total for p in probabilities])
        self._rng = np.random.default_rng(seed)
        self._seed = seed
        self._last_source = None
        if resume_state is not None:
            if (resume_state.get('version') != STATE_VERSION
                    or resume_state.get('mode') != 'mixture'):
                raise ValueError('resume_state is not a WeightedSamplingReader state '
                                 '(mode={!r})'.format(resume_state.get('mode')))
            if resume_state.get('n_sources') != len(readers):
                raise ValueError('resume_state captured {} sources; this mixture has {}'.format(
                    resume_state.get('n_sources'), len(readers)))
            self._rng.bit_generator.state = resume_state['rng_state']
        first = readers[0]
        for other in readers[1:]:
            if list(first.transformed_schema.fields) != list(other.transformed_schema.fields):
                raise ValueError('All mixed readers must share the same output schema')
            if first.batched_output != other.batched_output:
                raise ValueError('Cannot mix batched and per-row readers')
            if (first.ngram is None) != (other.ngram is None):
                raise ValueError('Cannot mix ngram and non-ngram readers')
        self.last_row_consumed = False
        draws = metrics.counter(
            'pst_weighted_reader_draws_total',
            'Samples drawn from each source of a WeightedSamplingReader',
            labelnames=('source',))
        self._m_draws = [draws.labels(str(i)) for i in range(len(readers))]

    @property
    def batched_output(self):
        return self._readers[0].batched_output

    @property
    def ngram(self):
        return self._readers[0].ngram

    @property
    def transformed_schema(self):
        return self._readers[0].transformed_schema

    @property
    def schema(self):
        return self._readers[0].schema

    @property
    def last_chunk_lineage(self):
        """The drawn source's segment of the most recent draw, with its
        ``source`` index."""
        if self._last_source is None:
            return None
        segment = getattr(self._readers[self._last_source], 'last_chunk_lineage', None)
        return None if segment is None else dict(segment, source=self._last_source)

    def lineage_context(self):
        """``mode='mixture'``, the seed, the normalised weights and each
        source's context (``sources[i]`` resolves a segment's ``source``)."""
        sources = []
        for reader in self._readers:
            ctx_fn = getattr(reader, 'lineage_context', None)
            sources.append(ctx_fn() if ctx_fn is not None else {'mode': None})
        return {'mode': 'mixture', 'seed': self._seed,
                'probabilities': [round(float(p), 6)
                                  for p in np.diff(np.concatenate([[0.0], self._cum]))],
                'sources': sources}

    def lineage_state(self):
        """Each source's live shuffle state."""
        states = []
        for reader in self._readers:
            state_fn = getattr(reader, 'lineage_state', None)
            states.append(state_fn() if state_fn is not None else None)
        return {'sources': states}

    def __iter__(self):
        return self

    def __next__(self):
        draw = self._rng.random()
        chosen = min(int(np.searchsorted(self._cum, draw, side='right')), len(self._readers) - 1)
        try:
            row = next(self._readers[chosen])
        except StopIteration:
            self.last_row_consumed = True
            raise
        self._last_source = chosen
        self._m_draws[chosen].inc()
        return row

    def state_dict(self):
        """The draw generator's state and each source's ``state_dict()``
        (JSON-safe)."""
        sources = []
        for reader in self._readers:
            state_fn = getattr(reader, 'state_dict', None)
            sources.append(state_fn() if state_fn is not None else None)
        return {'version': STATE_VERSION, 'mode': 'mixture', 'n_sources': len(self._readers),
                'rng_state': self._rng.bit_generator.state, 'sources': sources}

    def stop(self):
        for reader in self._readers:
            reader.stop()

    def join(self):
        for reader in self._readers:
            reader.join()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.stop()
        self.join()
        return False
