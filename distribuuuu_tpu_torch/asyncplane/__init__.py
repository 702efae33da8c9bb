"""The asynchronous plane of the port (counterpart of distribuuuu_tpu/asyncplane/):
the background checkpoint committer (``committer.py``) and concurrent
eval (``evalloop.py``)."""
