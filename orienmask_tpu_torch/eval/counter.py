"""Windowed and per-epoch (sum, count) accumulators of the train and val
logs (counterpart of ``orienmask_tpu/eval/counter.py``)."""

import pickle


class EvalCounter:
    def __init__(self):
        self.keys = []
        self.items = {}
        self.counter = {}
        self.items_epoch = {}
        self.counter_epoch = {}

    def reset(self):
        """Close the window: its sums join the epoch's."""
        for key in self.keys:
            self.items_epoch[key] += self.items[key]
            self.counter_epoch[key] += self.counter[key]
        self.items = {key: 0 for key in self.keys}
        self.counter = {key: 0.0 for key in self.keys}

    def reset_epoch(self):
        self.items = {key: 0 for key in self.keys}
        self.counter = {key: 0.0 for key in self.keys}
        self.items_epoch = {key: 0 for key in self.keys}
        self.counter_epoch = {key: 0.0 for key in self.keys}

    def update(self, key, value):
        """``value`` is a number (counted once) or a (sum, count) pair."""
        value, item = value if isinstance(value, (tuple, list)) else (value, 1)
        value = float(value)
        item = float(item)
        if key not in self.items:
            self.keys.append(key)
            self.items[key] = 0
            self.counter[key] = 0.0
            self.items_epoch[key] = 0
            self.counter_epoch[key] = 0.0
        self.items[key] += item
        self.counter[key] += value

    def average(self, key):
        return self.counter[key] / self.items[key] if self.items.get(key) else -1

    def average_epoch(self, key):
        self.items_epoch[key] += self.items[key]
        self.counter_epoch[key] += self.counter[key]
        self.items[key] = 0
        self.counter[key] = 0.0
        if not self.items_epoch[key]:
            return -1
        return self.counter_epoch[key] / self.items_epoch[key]

    def save(self, filename):
        with open(filename, "wb") as fh:
            pickle.dump({"items": self.items, "counter": self.counter}, fh)

    @staticmethod
    def load(filename):
        with open(filename, "rb") as fh:
            return pickle.load(fh)

    def merge(self, counter_dict):
        for key in self.keys:
            self.items[key] += counter_dict["items"].get(key, 0)
            self.counter[key] += counter_dict["counter"].get(key, 0.0)
