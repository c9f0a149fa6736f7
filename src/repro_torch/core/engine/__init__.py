"""Host-side scheduling pieces of the port (placement)."""
