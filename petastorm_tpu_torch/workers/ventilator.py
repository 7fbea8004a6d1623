"""Ventilator: the in-flight-capped work feeder.

Counterpart of ``petastorm_tpu/workers/ventilator.py:35-432``. It runs on
its own thread (or is pumped by a pool without threads), keeps at most
``max_ventilation_queue_size`` items unprocessed (fewer while the pool's
results watermark holds it back), and reshuffles the item order every epoch with
``random.Random(seed)``: the same generator and call sequence as the JAX
package, so one seed gives both packages the same row-group order.

Deterministic mode (``deterministic=``, armed by a reader built with
``deterministic=True``) replaces that shuffle by the Feistel permutation of
:mod:`petastorm_tpu_torch.determinism` keyed by ``(seed, epoch)``: a resume
fast-forwards to its cursor instead of replaying generator history, the
shard becomes a stride over the global order, and every fed item carries a
``pst_det`` tag (host-local ``seq``, absolute ``epoch``, global ``pos``)
that the workers echo on their chunks for the resequencer.

With a :class:`~petastorm_tpu_torch.health.Heartbeat` in ``heartbeat`` (set
by ``Reader.attach_health``) the feeder beats ``'ventilating'`` when it
feeds, ``'backpressure'`` when it holds and ``'idle'`` once every epoch is
out (``petastorm_tpu/workers/ventilator.py:139-143, 321-375``).
:meth:`ConcurrentVentilator.set_max_in_flight` retargets the cap while it
feeds (``:384-390``).
"""

import hashlib
import random
import threading

from petastorm_tpu_torch import determinism

THREAD_NAME = 'pstt-ventilator'
_POLL_S = 0.01


class ConcurrentVentilator(object):
    def __init__(self, ventilate_fn, items_to_ventilate, iterations=1,
                 randomize_item_order=False, random_seed=None,
                 max_ventilation_queue_size=None, deterministic=None):
        """
        :param ventilate_fn: called with ``**item`` for each item.
        :param items_to_ventilate: list of kwargs dicts.
        :param iterations: number of epochs; ``None`` = endless.
        :param randomize_item_order: reshuffle before each epoch.
        :param random_seed: seed of the epoch shuffles.
        :param max_ventilation_queue_size: cap on unprocessed items.
        :param deterministic: ``None``, or ``{'seed', 'shuffle', 'cur_shard',
            'shard_count', 'start_epoch', 'start_pos'}``: seed-stable
            feeding from the resume cursor ``(start_epoch, start_pos)``.
        """
        if iterations is not None and iterations <= 0:
            raise ValueError('iterations must be positive or None, got {}'.format(iterations))
        self._ventilate_fn = ventilate_fn
        self._items = list(items_to_ventilate)
        self._iterations = iterations
        self._iterations_remaining = iterations
        self._randomize = randomize_item_order
        self._rng = random.Random(random_seed)
        self._max_in_flight = (max_ventilation_queue_size
                               if max_ventilation_queue_size is not None else len(self._items))
        self._det = dict(deterministic) if deterministic is not None else None
        self._det_epoch = 0          # absolute epoch being fed (1-based)
        self._det_order = None       # epoch_order(...) of that epoch
        self._det_plan = None        # (epoch, order), replaced whole
        self._det_positions = None   # this shard's global positions in it
        self._det_epoch_base = 0     # the epoch's resume base
        self._det_phase = 0          # round-robin offset of earlier epochs
        self._det_seq = 0            # host-local sequence number
        #: Feed epochs started (absolute in deterministic mode), for lineage.
        self.epochs_started = 0
        self._epoch_order_digest = None
        self._position = 0
        self._in_flight = 0
        self._lock = threading.Lock()
        self._stop_event = threading.Event()
        self._wakeup = threading.Event()
        self._completed = threading.Event()
        self._started = False
        self._threaded = True
        self._thread = None
        #: Observer ``(item) -> None`` called just before each item is fed,
        #: in dispatch order (``max_ventilation_queue_size`` items ahead of
        #: the workers): the reader hangs the chunk store's readahead here.
        #: Its exceptions are swallowed: it is advice, not work.
        self.on_ventilate = None
        #: Saturation signal ``() -> None | bool``: None = unarmed (plain
        #: feeding up to the cap), True = hold, False = armed but clear:
        #: feed paced, one item per ack or per poll interval, so the signal
        #: sees each item's results land before the next is fed. The
        #: thread pool wires it to its results watermark.
        self.backpressure_fn = None
        #: The feeder's health heartbeat, or None.
        self.heartbeat = None

    def start(self, threaded=True):
        """Start ventilating: on a thread of its own, or (``threaded=False``,
        a pool without worker threads) one item per :meth:`pump` call."""
        if self._started:
            raise RuntimeError('Ventilator already started')
        self._started = True
        self._threaded = threaded
        if not self._items:
            self._completed.set()
            return
        if self._det is not None:
            if not self._det_start():
                self._completed.set()    # the cursor is past the last epoch
                return
        elif self._randomize:
            self._rng.shuffle(self._items)
        self._on_epoch_order()
        if threaded:
            self._thread = threading.Thread(target=self._ventilate, daemon=True,
                                            name=THREAD_NAME)
            self._thread.start()

    # -- deterministic feeding ---------------------------------------------

    def _det_start(self):
        """Position the feed at the resume cursor; False when its epoch is
        past a finite epoch budget."""
        start_epoch = max(1, int(self._det.get('start_epoch') or 1))
        if self._iterations is not None:
            self._iterations_remaining = self._iterations - (start_epoch - 1)
            if self._iterations_remaining <= 0:
                return False
        self._det_seq = 0
        self._det_epoch_setup(start_epoch, int(self._det.get('start_pos') or 0), phase=0)
        return True

    def _det_epoch_setup(self, epoch, base, phase):
        """One epoch's plan: the permuted order and this shard's positions
        over it (``phase`` keeps the round-robin continuous across epochs)."""
        det = self._det
        n = len(self._items)
        self._det_epoch = epoch
        self._det_epoch_base = base
        self._det_phase = phase
        self._det_order = determinism.epoch_order(n, det.get('seed'), epoch,
                                                  shuffle=det.get('shuffle', True))
        self._det_plan = (epoch, self._det_order)   # one read for lineage_state
        self._det_positions = determinism.shard_positions(
            n, base, det.get('cur_shard') or 0, det.get('shard_count') or 1, phase=phase)

    def _epoch_items(self):
        return len(self._det_positions) if self._det is not None else len(self._items)

    def _next_item(self):
        """The next item to feed; in deterministic mode the permutation's
        item, tagged with its ``pst_det`` identity."""
        i = self._position
        self._position += 1
        if self._det is None:
            return self._items[i]
        pos = self._det_positions[i]
        item = dict(self._items[self._det_order[pos]])
        item['pst_det'] = {'seq': self._det_seq, 'epoch': self._det_epoch, 'pos': pos}
        self._det_seq += 1
        return item

    # -- feeding -----------------------------------------------------------

    def pump(self):
        """Ventilate the next item on the caller's thread; False once every
        epoch is out (or after ``stop``)."""
        heartbeat = self.heartbeat
        if self._stop_event.is_set() or not self._advance_epoch():
            if heartbeat is not None:
                heartbeat.beat('idle')
            return False
        if heartbeat is not None:
            heartbeat.beat('ventilating')
        item = self._next_item()
        self._observe(item)
        self._ventilate_fn(**item)
        return True

    def _observe(self, item):
        observer = self.on_ventilate
        if observer is not None:
            try:
                observer(item)
            except Exception:  # noqa: BLE001 - advice must not stop the feed
                pass

    def _backpressured(self):
        """None (no signal armed, or it failed), False (armed, clear) or
        True (hold)."""
        fn = self.backpressure_fn
        if fn is None:
            return None
        try:
            value = fn()
        except Exception:  # noqa: BLE001 - a failing probe must not stop the feed
            return None
        return None if value is None else bool(value)

    def _advance_epoch(self):
        """Roll to the next epoch at the end of the list; False when done. A
        loop: a shard whose stride has no position left in the resume epoch
        rolls straight through."""
        while self._position >= self._epoch_items():
            if self._iterations_remaining is not None:
                self._iterations_remaining -= 1
                if self._iterations_remaining <= 0:
                    self._completed.set()
                    return False
            self._position = 0
            if self._det is not None:
                shard_count = self._det.get('shard_count') or 1
                phase = (self._det_phase + len(self._items) - self._det_epoch_base) % shard_count
                self._det_epoch_setup(self._det_epoch + 1, 0, phase)
            elif self._randomize:
                self._rng.shuffle(self._items)
            self._on_epoch_order()
        return True

    def _on_epoch_order(self):
        self.epochs_started = self._det_epoch if self._det is not None else self.epochs_started + 1
        self._epoch_order_digest = None

    def lineage_state(self):
        """``{'epoch', 'order_digest', 'position'}``: the live shuffle state
        stamped into provenance records (advisory near an epoch boundary).
        The digest is computed on first use in each epoch."""
        if self._det is not None:
            epoch, order = self._det_plan
        else:
            epoch = self.epochs_started
        memo = self._epoch_order_digest
        if memo is None or memo[0] != epoch:
            if self._det is not None:
                value = determinism.order_digest(self._items, order)
            else:
                digest = hashlib.md5()
                for index, item in enumerate(self._items):
                    digest.update(repr((item.get('piece_index', index),
                                        item.get('shuffle_row_drop_partition'))).encode())
                value = digest.hexdigest()[:12]
            memo = (epoch, value)
            self._epoch_order_digest = memo
        return {'epoch': epoch, 'order_digest': memo[1], 'position': self._position}

    def _ventilate(self):
        while not self._stop_event.is_set():
            heartbeat = self.heartbeat
            if not self._advance_epoch():
                if heartbeat is not None:
                    heartbeat.beat('idle')      # every epoch fed: quiet is not a stall
                return
            with self._lock:
                below_cap = self._in_flight < self._max_in_flight
            backpressure = self._backpressured() if below_cap else None
            if below_cap and not backpressure:
                if heartbeat is not None:
                    heartbeat.beat('ventilating')
                with self._lock:
                    self._in_flight += 1
                item = self._next_item()
                self._observe(item)
                self._ventilate_fn(**item)
                if backpressure is not None:
                    self._wakeup.clear()
                    self._wakeup.wait(_POLL_S)
            else:
                if heartbeat is not None:
                    heartbeat.beat('backpressure')
                self._wakeup.wait(_POLL_S)
                self._wakeup.clear()

    def processed_item(self):
        with self._lock:
            self._in_flight = max(0, self._in_flight - 1)
        self._wakeup.set()

    def set_max_in_flight(self, n):
        """Retarget the cap on unprocessed items while feeding (the
        autotuner's ``workers`` knob keeps it at workers + 2): a raised cap
        wakes a parked feeder at once; a lowered one holds new items until
        those in flight drain below it."""
        with self._lock:
            self._max_in_flight = max(1, int(n))
        self._wakeup.set()

    def completed(self):
        return self._completed.is_set()

    def reset(self):
        """Start another round of ``iterations`` epochs once the last one is
        out. In deterministic mode the round starts at epoch 1: the resume
        cursor was spent by the first start."""
        if self._thread is not None:
            if not self._completed.is_set():
                raise RuntimeError('Cannot reset a ventilator that is still ventilating')
            self._thread.join()
        elif self._started and not self._completed.is_set():
            raise RuntimeError('Cannot reset a ventilator that is still ventilating')
        self._thread = None
        self._started = False
        self._iterations_remaining = self._iterations
        self._position = 0
        if self._det is not None:
            self._det['start_epoch'] = 1
            self._det['start_pos'] = 0
        with self._lock:
            self._in_flight = 0
        self._completed.clear()
        self._stop_event.clear()
        self.start(threaded=self._threaded)

    def stop(self):
        self._stop_event.set()
        self._wakeup.set()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
