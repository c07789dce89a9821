"""AdamW and int8 gradient compression."""
