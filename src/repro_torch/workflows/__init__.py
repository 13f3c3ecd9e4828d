"""Dependent-request workflows: task DAGs, test-time-compute
workload templates, and energy-per-task accounting.

The port's own copy of ``repro.workflows``.
"""
from .graph import TaskReport, Workflow, WorkflowStep
from .source import WorkflowSource
from .templates import (WORKFLOW_TEMPLATES, agent_loop, fan_out,
                        make_workflow, rag_chain, speculative)

__all__ = [
    "Workflow", "WorkflowStep", "TaskReport", "WorkflowSource",
    "WORKFLOW_TEMPLATES", "make_workflow",
    "rag_chain", "agent_loop", "fan_out", "speculative",
]
