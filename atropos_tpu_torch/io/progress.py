"""Progress reporting wrappers for the batch iterator.

Message-based progress (log lines every N records) is always available;
bar-based progress uses progressbar2 or tqdm when importable.
Counterpart of ``atropos_tpu/io/progress.py``, one adapter class per
backend.
"""
import logging
import time

from atropos_tpu_torch.util import MAGNITUDE


def magnitude_formatter(magnitude):
    """value -> '12.3 M'-style string for the given magnitude suffix."""
    if magnitude is None:
        return lambda value: "{:.1f} ".format(value)
    divisor = float(MAGNITUDE[magnitude.upper()])
    return lambda value: "{:.1f} {}".format(value / divisor, magnitude)


def _batch_size_of(batch):
    """Record count carried by one (metadata, records) batch."""
    return batch[0]["size"]


class ProgressMessageReader:
    """Iterate batches, logging a progress line roughly every
    ``interval`` records."""

    def __init__(self, iterable, batch_size, interval=1000000,
                 max_items=None, mag_format=None):
        self.iterable = iterable
        self.batch_size = batch_size
        self.interval = interval
        self.ctr = 0
        self.mag_format = mag_format
        self.start_time = None
        if max_items:
            shown = mag_format(max_items) if mag_format else str(max_items)
            self.msg = "Read {0}/%s records in {1:.1f} seconds" % shown
        else:
            self.msg = "Read {0} records in {1:.1f} seconds"

    def __iter__(self):
        self.start_time = time.time()
        return self

    def __next__(self):
        batch = next(self.iterable)
        if batch:
            self.ctr += _batch_size_of(batch)
            if self.ctr % self.interval < self.batch_size:
                elapsed = time.time() - self.start_time
                shown = (
                    self.mag_format(self.ctr) if self.mag_format else self.ctr
                )
                logging.getLogger().info(self.msg.format(shown, elapsed))
        return batch

    next = __next__

    def close(self):
        logging.getLogger().info("Read a total of %s records", self.ctr)


def create_progress_reader(
    reader, progress_type="msg", batch_size=1, max_items=None,
    counter_magnitude="M", **kwargs
):
    """Wrap an iterable of batches in a progress reporter. Bar mode tries
    progressbar2, then tqdm, then returns the reader unwrapped with a
    warning (reference surface: ``atropos/io/progress.py:64-105``)."""
    mag_format = magnitude_formatter(counter_magnitude)

    if progress_type == "msg":
        return ProgressMessageReader(
            reader, batch_size, max_items=max_items, mag_format=mag_format,
            **kwargs
        )

    for factory in (
        lambda: create_progressbar_reader(
            reader, max_items, mag_format, **kwargs
        ),
        lambda: create_tqdm_reader(reader, max_items, **kwargs),
    ):
        try:
            return factory()
        except Exception:
            continue

    logging.getLogger().warning("No progress bar library available")
    return reader


def create_progressbar_reader(reader, max_reads=None, mag_format=None):
    """Wrap a batch iterable in a progressbar2 ProgressBar (reference
    surface: ``atropos/io/progress.py:118-184``)."""
    import progressbar
    import progressbar.widgets

    class _BarReader(progressbar.ProgressBar):
        """ProgressBar that advances by each batch's record count."""

        def __init__(self, iterable, widgets, max_value=None):
            super().__init__(
                widgets=widgets,
                max_value=max_value or progressbar.UnknownLength,
            )
            self._iterable = iterable
            self._finished = False

        def __next__(self):
            try:
                batch = next(self._iterable)
            except StopIteration:
                self.close()
                raise
            if self.start_time is None:
                self.start()
            self.update(self.value + _batch_size_of(batch))
            return batch

        def close(self):
            if not self._finished:
                self.finish()
                self._finished = True
            closer = getattr(self._iterable, "close", None)
            if closer is not None:
                try:
                    closer()
                except Exception:
                    pass

    class _MagCounter(progressbar.widgets.WidgetBase):
        """Counter widget rendering through the magnitude formatter."""

        def __init__(self, fmt):
            super().__init__()
            self._format = fmt

        def __call__(self, progress, data):
            return self._format(data["value"])

    if max_reads:
        widgets = [
            _MagCounter(mag_format), " Reads (", progressbar.Percentage(),
            ") ", progressbar.Timer(), " ", progressbar.Bar(),
            progressbar.AdaptiveETA(),
        ]
        return _BarReader(reader, widgets, max_reads)
    widgets = [
        _MagCounter(mag_format), " Reads", progressbar.Timer(),
        progressbar.AnimatedMarker(),
    ]
    return _BarReader(reader, widgets)


def create_tqdm_reader(reader, max_reads=None):
    """Wrap an iterable in a tqdm progress bar."""
    import tqdm

    return tqdm.tqdm(reader, total=max_reads)
