"""Global state queries: the port's copy of ``ray_tpu/_private/state.py``.

They read ``init``'s logical resources (what the running tasks take) and
the host's card ledger (``_private/cards.py``): ``GPU`` is the cards the
ledger grants (``init``'s ``num_gpus`` when it was given) and what of them
no lease holds. In a process the driver spawned they run in the driver.
"""

from __future__ import annotations


def cluster_resources() -> dict:
    from ray_tpu_torch._private.worker import _api

    return _api().op_resources(0)


def available_resources() -> dict:
    from ray_tpu_torch._private.worker import _api

    return _api().op_resources(1)


def nodes() -> list[dict]:
    """The host's node, as ``util.state.list_nodes()`` gives it."""
    from ray_tpu_torch.util.state import list_nodes

    return list_nodes()
