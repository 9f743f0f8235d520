"""Notebook training callbacks of the port (counterpart of
``mxnet_tpu/notebook/callback.py``; reference:
python/mxnet/notebook/callback.py): ``PandasLogger`` collects per-batch
and per-epoch metrics into pandas DataFrames, ``LiveLearningCurve`` plots
them with matplotlib in a notebook. ``pandas``, ``matplotlib`` and
``IPython`` are imported when first used, not with the module.

Usage::

    logger = PandasLogger(batch_size)
    mod.fit(..., batch_end_callback=logger.train_cb,
            eval_batch_end_callback=logger.eval_cb,
            epoch_end_callback=logger.epoch_cb)
    logger.train_df  # pandas DataFrame of training metrics over time
"""
import time


class PandasLogger:
    """Collects train/eval metrics into pandas DataFrames
    (reference: notebook/callback.py PandasLogger)."""

    def __init__(self, batch_size, frequent=50):
        import pandas as pd

        self.batch_size = batch_size
        self.frequent = frequent
        self._tic = time.time()
        self._dataframes = {
            "train": pd.DataFrame(),
            "eval": pd.DataFrame(),
            "epoch": pd.DataFrame(),
        }

    @property
    def train_df(self):
        return self._dataframes["train"]

    @property
    def eval_df(self):
        return self._dataframes["eval"]

    @property
    def epoch_df(self):
        return self._dataframes["epoch"]

    @property
    def all_dataframes(self):
        return dict(self._dataframes)

    def elapsed(self):
        return time.time() - self._tic

    def append_metrics(self, metrics, df_name):
        import pandas as pd

        df = self._dataframes[df_name]
        row = pd.DataFrame([metrics])
        self._dataframes[df_name] = pd.concat([df, row], ignore_index=True)

    def _process_batch(self, param, df_name):
        metrics = dict(param.eval_metric.get_name_value()) if param.eval_metric else {}
        metrics["elapsed"] = self.elapsed()
        metrics["epoch"] = param.epoch
        metrics["nbatch"] = param.nbatch
        self.append_metrics(metrics, df_name)

    def train_cb(self, param):
        if param.nbatch % self.frequent == 0:
            self._process_batch(param, "train")

    def eval_cb(self, param):
        self._process_batch(param, "eval")

    def epoch_cb(self, epoch=None, symbol=None, arg_params=None, aux_params=None):
        self.append_metrics({"elapsed": self.elapsed(), "epoch": epoch}, "epoch")

    def callback_args(self):
        """kwargs dict to splat into Module.fit (reference's convenience)."""
        return {
            "batch_end_callback": self.train_cb,
            "eval_batch_end_callback": self.eval_cb,
            "epoch_end_callback": self.epoch_cb,
        }


class LiveLearningCurve:
    """Live-updating metric plot for notebooks (reference's LiveBokehChart,
    matplotlib-backed here; degrades to storing data when matplotlib or a
    display is unavailable)."""

    def __init__(self, metric_name="accuracy", display_freq=10):
        self.metric_name = metric_name
        self.display_freq = display_freq
        self._data = {"train": [], "eval": []}
        self._n = 0
        self._fig = None

    def train_cb(self, param):
        self._record(param, "train")

    def eval_cb(self, param):
        self._record(param, "eval")

    def _record(self, param, phase):
        if not param.eval_metric:
            return
        for name, value in param.eval_metric.get_name_value():
            if name == self.metric_name or self.metric_name is None:
                self._data[phase].append(value)
        self._n += 1
        if self._n % self.display_freq == 0:
            self._draw()

    def _draw(self):
        try:
            import matplotlib.pyplot as plt
            from IPython import display
        except ImportError:
            return
        if self._fig is None:
            self._fig = plt.figure()
        plt.clf()
        for phase, values in self._data.items():
            if values:
                plt.plot(values, label=phase)
        plt.xlabel("updates")
        plt.ylabel(self.metric_name)
        plt.legend()
        display.clear_output(wait=True)
        display.display(self._fig)

    @property
    def data(self):
        return dict(self._data)
