"""The database schema config (database_config.yaml).

Parity with reference src/silo/config/database_config.cpp and the validation
rules of src/silo/config/config_repository.cpp:15-110.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field

from .yaml_subset import load_file as _load_yaml


class ConfigError(Exception):
    pass


class ValueType(enum.Enum):
    STRING = "string"
    DATE = "date"
    PANGOLINEAGE = "pango_lineage"
    INT = "int"
    FLOAT = "float"
    NUC_INSERTION = "insertion"
    AA_INSERTION = "aaInsertion"


def to_value_type(type_str: str) -> ValueType:
    for member in ValueType:
        if member.value == type_str:
            return member
    raise ConfigError(f"Unknown metadata type: {type_str}")


class ColumnType(enum.Enum):
    """Physical column type (reference: DatabaseMetadata::getColumnType)."""

    STRING = "string"
    INDEXED_STRING = "indexed_string"
    DATE = "date"
    INDEXED_PANGOLINEAGE = "indexed_pango_lineage"
    INT = "int"
    FLOAT = "float"
    NUC_INSERTION = "nuc_insertion"
    AA_INSERTION = "aa_insertion"


@dataclass
class Metadata:
    name: str
    type: ValueType
    generate_index: bool = False

    def column_type(self) -> ColumnType:
        if self.type == ValueType.STRING:
            return ColumnType.INDEXED_STRING if self.generate_index else ColumnType.STRING
        if self.type == ValueType.DATE:
            return ColumnType.DATE
        if self.type == ValueType.PANGOLINEAGE:
            if self.generate_index:
                return ColumnType.INDEXED_PANGOLINEAGE
            raise ConfigError("Found pango lineage column without index: " + self.name)
        if self.type == ValueType.INT:
            return ColumnType.INT
        if self.type == ValueType.FLOAT:
            return ColumnType.FLOAT
        if self.type == ValueType.NUC_INSERTION:
            return ColumnType.NUC_INSERTION
        if self.type == ValueType.AA_INSERTION:
            return ColumnType.AA_INSERTION
        raise ConfigError("Unknown value type")


@dataclass
class DatabaseSchema:
    instance_name: str
    primary_key: str
    metadata: list[Metadata] = field(default_factory=list)
    date_to_sort_by: str | None = None
    partition_by: str | None = None


@dataclass
class DatabaseConfig:
    schema: DatabaseSchema
    default_nucleotide_sequence: str = "main"

    def get_metadata(self, name: str) -> Metadata | None:
        for m in self.schema.metadata:
            if m.name == name:
                return m
        return None

    def to_dict(self) -> dict:
        schema: dict = {
            "instanceName": self.schema.instance_name,
            "primaryKey": self.schema.primary_key,
        }
        if self.schema.partition_by is not None:
            schema["partitionBy"] = self.schema.partition_by
        if self.schema.date_to_sort_by is not None:
            schema["dateToSortBy"] = self.schema.date_to_sort_by
        schema["metadata"] = [
            {
                "name": m.name,
                "type": m.type.value,
                **({"generateIndex": True} if m.generate_index else {}),
            }
            for m in self.schema.metadata
        ]
        result = {"schema": schema}
        if self.default_nucleotide_sequence != "main":
            result["defaultNucleotideSequence"] = self.default_nucleotide_sequence
        return result


def parse_database_config(data: dict) -> DatabaseConfig:
    try:
        schema_node = data["schema"]
        metadata = []
        for m in schema_node["metadata"]:
            value_type = to_value_type(m["type"])
            # generateIndex defaults to true for pango lineage columns
            # (reference database_config.cpp:138-142)
            generate_index = bool(
                m.get("generateIndex", value_type == ValueType.PANGOLINEAGE)
            )
            metadata.append(Metadata(name=m["name"], type=value_type,
                                     generate_index=generate_index))
        schema = DatabaseSchema(
            instance_name=schema_node["instanceName"],
            primary_key=schema_node["primaryKey"],
            metadata=metadata,
            date_to_sort_by=schema_node.get("dateToSortBy"),
            partition_by=schema_node.get("partitionBy"),
        )
    except (KeyError, TypeError) as ex:
        raise ConfigError(f"Failed to read database config: {ex}") from ex
    return DatabaseConfig(
        schema=schema,
        default_nucleotide_sequence=data.get("defaultNucleotideSequence", "main"),
    )


def read_database_config(path) -> DatabaseConfig:
    data = _load_yaml(path)
    if data is None:
        raise ConfigError(f"Empty database config: {path}")
    return parse_database_config(data)


def validate_config(config: DatabaseConfig) -> None:
    """Reference: config_repository.cpp:21-105 (same rules, same intent)."""
    metadata_map: dict[str, ValueType] = {}
    for metadata in config.schema.metadata:
        if metadata.name in metadata_map:
            raise ConfigError(f"Metadata {metadata.name} is defined twice in the config")
        indexable = metadata.type in (ValueType.STRING, ValueType.PANGOLINEAGE)
        if metadata.generate_index and not indexable:
            raise ConfigError(
                f"Metadata '{metadata.name}' generate_index is set, but generating an index "
                "is only allowed for types STRING and PANGOLINEAGE"
            )
        if metadata.type == ValueType.PANGOLINEAGE and not metadata.generate_index:
            raise ConfigError(
                f"Metadata '{metadata.name}' generate_index is not set, but generating an "
                "index is mandatory for type PANGOLINEAGE"
            )
        metadata_map[metadata.name] = metadata.type
    if not config.schema.metadata:
        raise ConfigError("Database config without fields not possible")
    if config.schema.primary_key not in metadata_map:
        raise ConfigError("Primary key is not in metadata")
    if config.schema.date_to_sort_by is not None:
        if config.schema.date_to_sort_by not in metadata_map:
            raise ConfigError(
                f"date_to_sort_by '{config.schema.date_to_sort_by}' is not in metadata"
            )
        if metadata_map[config.schema.date_to_sort_by] != ValueType.DATE:
            raise ConfigError(
                f"date_to_sort_by '{config.schema.date_to_sort_by}' must be of type DATE"
            )
    if config.schema.partition_by is not None:
        if config.schema.partition_by not in metadata_map:
            raise ConfigError(f"partition_by '{config.schema.partition_by}' is not in metadata")
        if metadata_map[config.schema.partition_by] != ValueType.PANGOLINEAGE:
            raise ConfigError(
                f"partition_by '{config.schema.partition_by}' must be of type PANGOLINEAGE"
            )


def get_validated_config(path) -> DatabaseConfig:
    config = read_database_config(path)
    validate_config(config)
    return config
