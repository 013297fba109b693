"""The paper's batch codec: ISE structure extraction + the 3-level codec."""
