"""ray_tpu_torch.util.state: cluster state inspection API (reference:
python/ray/util/state)."""

from ray_tpu_torch.util.state.api import (
    critical_path,
    get_log,
    list_actors,
    list_jobs,
    list_logs,
    list_nodes,
    list_objects,
    list_placement_groups,
    list_spans,
    list_tasks,
    list_workers,
    summarize_actors,
    summarize_objects,
    summarize_tasks,
    timeline,
)

__all__ = [
    "critical_path",
    "get_log",
    "list_actors",
    "list_jobs",
    "list_logs",
    "list_nodes",
    "list_objects",
    "list_placement_groups",
    "list_spans",
    "list_tasks",
    "list_workers",
    "summarize_actors",
    "summarize_objects",
    "summarize_tasks",
    "timeline",
]
