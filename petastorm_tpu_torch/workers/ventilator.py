"""Ventilator: the in-flight-capped work feeder.

Counterpart of ``petastorm_tpu/workers/ventilator.py:35-432`` without
deterministic mode and backpressure signals. It runs on its own thread (or
is pumped by a pool without threads), keeps at most ``max_ventilation_queue_size`` items unprocessed,
and reshuffles the item order every epoch with ``random.Random(seed)``:
the same generator and call sequence as the JAX package, so one seed gives
both packages the same row-group order.
"""

import random
import threading

THREAD_NAME = 'pstt-ventilator'
_POLL_S = 0.01


class ConcurrentVentilator(object):
    def __init__(self, ventilate_fn, items_to_ventilate, iterations=1,
                 randomize_item_order=False, random_seed=None,
                 max_ventilation_queue_size=None):
        """
        :param ventilate_fn: called with ``**item`` for each item.
        :param items_to_ventilate: list of kwargs dicts.
        :param iterations: number of epochs; ``None`` = endless.
        :param randomize_item_order: reshuffle before each epoch.
        :param random_seed: seed of the epoch shuffles.
        :param max_ventilation_queue_size: cap on unprocessed items.
        """
        if iterations is not None and iterations <= 0:
            raise ValueError('iterations must be positive or None, got {}'.format(iterations))
        self._ventilate_fn = ventilate_fn
        self._items = list(items_to_ventilate)
        self._iterations_remaining = iterations
        self._randomize = randomize_item_order
        self._rng = random.Random(random_seed)
        self._max_in_flight = (max_ventilation_queue_size
                               if max_ventilation_queue_size is not None else len(self._items))
        self._position = 0
        self._in_flight = 0
        self._lock = threading.Lock()
        self._stop_event = threading.Event()
        self._wakeup = threading.Event()
        self._completed = threading.Event()
        self._started = False
        self._thread = None

    def start(self, threaded=True):
        """Start ventilating: on a thread of its own, or (``threaded=False``,
        a pool without worker threads) one item per :meth:`pump` call."""
        if self._started:
            raise RuntimeError('Ventilator already started')
        self._started = True
        if not self._items:
            self._completed.set()
            return
        self._new_epoch_order()
        if threaded:
            self._thread = threading.Thread(target=self._ventilate, daemon=True,
                                            name=THREAD_NAME)
            self._thread.start()

    def pump(self):
        """Ventilate the next item on the caller's thread; False once every
        epoch is out (or after ``stop``)."""
        if self._stop_event.is_set() or not self._advance_epoch():
            return False
        item = self._items[self._position]
        self._position += 1
        self._ventilate_fn(**item)
        return True

    def _new_epoch_order(self):
        if self._randomize:
            self._rng.shuffle(self._items)

    def _advance_epoch(self):
        """Roll to the next epoch at the end of the list; False when done."""
        if self._position < len(self._items):
            return True
        if self._iterations_remaining is not None:
            self._iterations_remaining -= 1
            if self._iterations_remaining <= 0:
                self._completed.set()
                return False
        self._position = 0
        self._new_epoch_order()
        return True

    def _ventilate(self):
        while not self._stop_event.is_set():
            if not self._advance_epoch():
                return
            with self._lock:
                below_cap = self._in_flight < self._max_in_flight
                if below_cap:
                    self._in_flight += 1
            if below_cap:
                item = self._items[self._position]
                self._position += 1
                self._ventilate_fn(**item)
            else:
                self._wakeup.wait(_POLL_S)
                self._wakeup.clear()

    def processed_item(self):
        with self._lock:
            self._in_flight = max(0, self._in_flight - 1)
        self._wakeup.set()

    def completed(self):
        return self._completed.is_set()

    def stop(self):
        self._stop_event.set()
        self._wakeup.set()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
