"""The paper's six CNN workloads as layer-graph emitters."""
