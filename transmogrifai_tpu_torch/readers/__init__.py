"""Data readers (counterpart of ``transmogrifai_tpu.readers``): the
in-memory, CSV, JSON-lines and Avro readers."""
from .base import (Reader, DataFrameReader, RecordsReader,  # noqa: F401
                   reader_for)
from .files import (CSVReader, CSVAutoReader, ParquetReader,  # noqa: F401
                    JSONLinesReader, DataReaders)
from .avro import (AvroReader, AvroSchemaCSVReader, read_avro,  # noqa: F401
                   write_avro, schema_feature_types)
