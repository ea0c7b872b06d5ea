"""Workload power modeling: device states, phase timelines, scenario
engine and trace synthesis (port of ``repro.power`` without its fault
engine)."""
