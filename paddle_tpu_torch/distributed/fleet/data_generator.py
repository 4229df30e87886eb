"""Fleet data generators (the counterpart of
``paddle_tpu/distributed/fleet/data_generator.py``): the producer side
of the MultiSlot pipe.  A generator script reads raw lines on stdin and
writes ``<n> v1 ... vn`` slot text on stdout, which a
:class:`.dataset.QueueDataset`'s ``pipe_command`` reads.  The text is
the JAX package's, byte for byte."""
from __future__ import annotations

import sys

__all__ = ["DataGenerator", "MultiSlotDataGenerator",
           "MultiSlotStringDataGenerator"]


class DataGenerator:
    def __init__(self):
        self.batch_size_ = 32

    def set_batch(self, batch_size):
        self.batch_size_ = batch_size

    # -- the user's hooks --------------------------------------------------
    def generate_sample(self, line):
        """A ``local_iter()`` yielding ``(slot_name, values)`` tuples for
        one raw input line."""
        raise NotImplementedError(
            "Please rewrite this function to return a list or tuple: " +
            "[(name, [feasign, ...]), ...] or ((name, [feasign, ...]), ...)")

    def generate_batch(self, samples):
        """A batch-level rewrite; by default each sample unchanged."""
        def local_iter():
            for sample in samples:
                yield sample
        return local_iter

    # -- running the generator ----------------------------------------------
    def _run(self, lines, out=None):
        out = out or sys.stdout
        batch = []

        def flush(batch):
            for sample in self.generate_batch(batch)():
                out.write(self._gen_str(sample))

        for line in lines:
            it = self.generate_sample(line)
            for parsed in it():
                if parsed is None:
                    continue
                batch.append(parsed)
                if len(batch) == self.batch_size_:
                    flush(batch)
                    batch = []
        if batch:
            flush(batch)

    def run_from_memory(self):
        self._run([None])

    def run_from_stdin(self):
        self._run(sys.stdin)

    def _gen_str(self, line):
        raise NotImplementedError(
            "Please inherit MultiSlotDataGenerator or "
            "MultiSlotStringDataGenerator to implement _gen_str")


class MultiSlotStringDataGenerator(DataGenerator):
    """Slots whose values are strings already."""

    def _gen_str(self, line):
        if not isinstance(line, (list, tuple)):
            raise ValueError(
                "the output of process() must be in list or tuple type")
        out = ""
        for name, elements in line:
            out += str(len(elements)) + " " + " ".join(elements) + " "
        return out.strip() + "\n"


class MultiSlotDataGenerator(DataGenerator):
    """Slots of ints or floats; an empty slot raises."""

    def _gen_str(self, line):
        if not isinstance(line, (list, tuple)):
            raise ValueError(
                "the output of process() must be in list or tuple type")
        out = ""
        for name, elements in line:
            if not elements:
                raise ValueError(
                    f"the elements of slot {name} are empty")
            out += str(len(elements)) + " " + " ".join(
                str(x) for x in elements) + " "
        return out.strip() + "\n"
