"""The ATAC stages of the port: generate-permit-list, sort, collate and
deduplicate (port of ``alevin_fry_tpu/atac/``, reference src/atac/)."""
